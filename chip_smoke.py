"""Smoke run of the PyTorch port (tpuclip_torch) on one CUDA card.

    python3 chip_smoke.py [--ab LABEL:PATH] ...

With ``--ab``, phase 3 also builds each other ``int8_scan.cu``,
``binary_scan.cu``, ``topk_bf16.cu`` or ``patch_embed.cu`` given (say, an
older tree's; the file name says which) into its own library and times its
kernels against this tree's in turns (theirs, this, this, theirs) on the
same inputs: kernels 2 and 3 bit-equal, with the fused int8 search and
``topk_int8`` routed through each; kernels 6 and 7 bit-equal at the
10M-row cases below; kernel 4's per-tile candidates (scores within 1e-5)
at Q = 1, 16, 64 on the 1M bf16 rows; kernel 8's bf16 out (within one bf16
step) at R = 16,384. An older ``patch_embed.cu`` is called with its own
C signature (K-major zero-padded weights and an f32 bias, made outside the
timed launch).

Phases, each printing its own lines; any failure exits non-zero:

1. environment: torch / CUDA versions, the card's name and power limit
   (nvidia-smi), TF32 off;
2. build: the CUDA kernels from tpuclip_torch/csrc (one nvcc per source, in
   parallel), timed, and beside them a register-only loop of b1 mmas whose
   rate is the binary tensor cores' peak in the bounds of kernels 6 and 7;
3. kernels against their plain PyTorch versions at the main path's size,
   1,000,000 unit-norm rows x 1152 (numpy seed 0, bf16 rows + int8 matrix
   on the card): int8_scores at Q = 1, 16 and int8_candidates_packed at
   Q = 16, 64 bit-equal; the fused int8 search at Q = 1, 16, k = 20 with
   the same ids and scores within 1e-6 as the route through the plain
   versions; topk_tiles (kernel 4) on the bf16 rows at Q = 1, 16 and
   k = 20, 128 with scores within 1e-5 of the plain version, every row
   within 1e-5 of the plain k-th score, ordered (score desc, row asc), and
   at k = 128 with one selection lane's slots all among the top rows; the
   bf16 route above k = 128 (topk_plain, a chunked fp32 matmul) at k = 200
   within 1e-5 of the float64 reference, timed (kernel 4 also as its own
   launch, without the merge); then 10,000,000 packed
   binary rows x 36 words (a seeded torch.Generator on the card):
   binary_scores bit-equal, binary_topk_q1 at k = 20, 640, 4096 and
   binary_topk_batched at Q = 4, 16, k = 20, 640 and Q = 64, k = 20
   identical to the plain version, each with its bound and the bytes of
   its scratch; CUDA-event p50 times of each kernel and its plain version,
   and of kernel 5 + torch.topk per query at the recorded cases.
   Also on the 1M int8 matrix: int8_candidates (kernel 3) at Q = 1, k_tile
   = 20, 80, 128 and Q = 16, k_tile = 80 bit-equal, ties planted (copies
   of one row in one tile; the top 128 of another tile in two selection
   lanes' slots), and topk_int8 (kernel 3 + merge) against the plain route,
   timed beside kernel 1 + torch.topk over the same scores; kernel 3 at
   Q = 1, k_tile = 80 on a 4,000,000 x 1152 int8 matrix (a seeded
   torch.Generator on the card; the size where the host route is the
   default) bit-equal, with topk_int8 beside the same two-call route;
   quantize_matrix on 65,536 fp32 rows bit-equal to numpy; and
   patch_embed_fused (kernel 8) on 64 seeded 224 x 224 uint8 images (R =
   16,384 patch rows x 588 -> 1152, seeded bf16 weights) within 1e-5 of the
   plain version in f32 out and one bf16 step in bf16 out, timed (the
   wrapper and the kernel's own launch) beside the tower's own cuBLAS patch
   GEMM;
4. end to end through the entry points: 512 seeded JPEGs, ``scan`` and
   ``search "a red car" -k 20 --no-session`` through tpuclip_torch.cli, and
   ``ImageDatabase.search_texts`` on 4 texts, with SigLIP2 SO400M-patch14-224
   at full width and random weights (TPUCLIP_INIT=random), bf16. Both int8
   kernel launch counters must rise in this phase; the CLI's results must
   match a brute-force rescore of the database, the batch's the plain
   route's, and embeddings must be unit-norm;
5. the other search paths end to end on phase 4's database: ``search
   --precision bf16`` against a brute-force bf16 scan; ``search --mode
   cascade`` and a 4-text ``search_texts`` in cascade mode against an fp32
   brute force over the stored vectors (the default depth of 640 covers
   all 512 rows); ``scan --binary-only`` into a second database, then
   ``search`` against a brute-force popcount over the stored sign bits and
   both ``search`` and a 4-text ``search_texts`` against the route through
   the plain versions. The references read the SQLite files directly. Kernels 4-7's launch counters must rise in this phase;
6. folder filters and the int8 search without the resident rows, on the
   same two databases: ``search --folder <images>/set_1`` in the default
   int8 mode (the masked route, rescored in fp32 from the host), with
   ``--precision bf16``, with ``--mode cascade`` and on the binary-only
   database, each against a brute force over set_1's stored rows; then
   with TPUCLIP_DEVICE_RERANK=0 a CLI search (kernel 3, then the host
   rescore) and a 4-text ``search_texts`` (kernel 1, then the host
   rescore), identical to the plain route with every score within 1e-6 of
   its row's fp32 dot, and with TPUCLIP_SEARCH_RERANK=0 a CLI search
   (kernel 3's int8 scores themselves) identical to the plain route; the
   bytes the host route keeps on the card. Kernels 1, 3 and 5's launch
   counters must rise in this phase;
7. the library entry point ``tpuclip_torch.ops.patch_embed_fused`` on 64 of
   the JPEGs with the vision tower's own patch weights, loosely equal to
   the tower's patch embedding; kernel 8's launch counter must rise;
8. the fused query programs (``text_topk_fused``, ``image_topk_fused``,
   ``mixed_topk_fused``) at SO400M width over phase 3's 1M resident rows,
   k = 20, each captured as a CUDA graph by the index's runner
   (``tpuclip_torch.ops.graphs``): text buckets 1, 4, 16, 64, the lone
   image, mixed (1, 1), (4, 4), (16, 16). Graph replay bit-equal to the
   eager program, ids identical to the two-stage route (tower, the
   embedding to the host and back, the fused search) with scores within
   1e-6; the CUDA-event p50 of 20 replays and of the eager program, the
   host-to-host wall p50 of the three routes, capture seconds and the
   shared pool's bytes; the text tower alone, graph against eager, at
   batch 1 and 4. Kernels 1 and 2 must count exactly the programs' runs;
9. ``serve`` end to end on phase 4's database, the rerank rows forced on:
   ``warm_programs`` must make 24 calls (21 graphs); /health, /stats, a
   text and a mini-language /search, an image_b64 /search, a 4-text
   /search_batch, /embed and /classify, then 4 texts + 4 uploads behind a
   barrier (one mixed window at least), every answer 200 and equal to the
   two-stage route at the same batch shapes (paths identical, scores
   within 1e-6); 50 sequential text /search (wall p50, p99) and where a
   request's time goes; two text /search after a forced re-upload, which
   drops every graph (the first captures its program again); a clean
   shutdown. Kernels 1 and 2 must rise;
10. the CLI and the interactive session on phase 4's database: ``search
   --interactive`` driven by a scripted stdin (``k:``, a text query, a
   ``folder:`` filter, ``folder:clear``, three negatives, ``image: + text``,
   ``duplicates:show``, ``quit``), each printed list id-identical to the
   engine's single search with the same arguments (scores equal to the
   printed 4 decimals), the towers loaded once, the index uploaded once and
   kernel 1 launched once per search line; the walls of the first and the
   later session queries, and of a ``search`` process from start to exit,
   with ``--no-session`` and as a session on a non-tty stdin (which must
   exit 0); ``selftest --e2e-only --device cuda`` all PASS; on a copy of
   the database ``info``, ``check``, ``export`` (npz), ``duplicates``,
   ``prune --dry-run``, ``migrate --dry-run`` and ``migrate`` (on a copy
   rewritten to the reference's vec0 layout), ``merge`` and ``gc
   --dry-run`` each exit 0, and the exported, migrated and merged rows equal
   the SQLite rows read directly.
   Neither jax nor the JAX package (tpuclip) may ever have been imported.

The last two lines are the kernels' JSON record and then
``{"ok": true, "device": {...}}``. Kernel 7 has two records, at Q = 4,
k = 640 (``binary_topk_batched``) and Q = 16, k = 20
(``binary_topk_batched_q16``). Each kernel's record carries its bound:
the larger of the bytes it must move (each input read once, each output
written once) over 3.35 TB/s and its operations over the peak rate of
their type (int8 1,979 TOP/s, bf16 989 TFLOP/s, kernel 5's popcounts 16
per SM per clock at 1.98 GHz, kernels 6 and 7's b1 AND + add at the rate
phase 2 measures), at the recorded case's shapes; ``launches`` counts
phase 4's path for kernels 1 and 2, and their ``launches_fused`` and
``launches_serve`` phases 8's and 9's; every kernel's ``launches_session``
counts phase 10's session (0 where the session does not run it); each count
is zeroed just before its path runs. ``library_ms`` is null
(no single PyTorch call computes any of these functions) and
``nearest_ms`` times the nearest route of PyTorch calls, where there is
one. Kernels 4 and 8 also carry ``kernel_ms``, the kernel's own launch
(``ms`` is the wrapper's).
"""

import argparse
import ctypes
import json
import os
import sqlite3
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

N_ROWS = 1_000_000
DIM = 1152
K = 20
N_IMAGES = 512
N_BINARY = 10_000_000  # the cascade's documented scale (tpuclip/index/search.py:92-97)
WORDS = DIM // 32
TEXTS = ["a red car", "blue sky", "a dog on a beach", "city lights at night"]
N_ROWS_4M = 4_000_000  # past the rerank gate (~2.31M rows): kernel 3's route is the default

# H100 SXM peaks (NVIDIA's data sheet; popcounts: 16 per SM per clock,
# 132 SMs, 1.98 GHz boost clock).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "popc": 16 * 132 * 1.98e9}


# The binary tensor cores' rate (mma.sync m16n8k256 b1, AND + POPC), which
# the published tables do not give, is measured in phase 2 by this loop:
# each warp runs four independent chains of mmas on registers.
B1_RATE_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void b1_mma_loop(int* out, int iters) {
  const unsigned x = threadIdx.x * 2654435761u;
  const unsigned a0 = x, a1 = x ^ 0x5bd1e995u, a2 = x * 3u, a3 = ~x, b0 = x >> 3, b1 = x * 7u;
  int d[4][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      asm volatile("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
                   : "+r"(d[c][0]), "+r"(d[c][1]), "+r"(d[c][2]), "+r"(d[c][3])
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  int s = 0;
  for (int c = 0; c < 4; ++c)
    for (int e = 0; e < 4; ++e) s += d[c][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int b1_mma_loop_launch(void* out, int blocks, int iters, void* stream) {
  b1_mma_loop<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<int*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
"""
B1_OPS_PER_MMA = 2 * 16 * 8 * 256  # an AND and an add per bit pair, as NVIDIA counts int8 TOPS


def start_b1_rate_build():
    """nvcc of the b1 rate loop into build/b1_rate/, started beside the
    kernels' build; returns (library path, process)."""
    from tpuclip_torch.ops import _build

    out_dir = _build.BUILD_DIR.parent / "b1_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "b1_rate.cu").write_text(B1_RATE_SOURCE)
    lib = out_dir / "libb1_rate.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(out_dir / "b1_rate.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def measure_b1_rate(build, gpu):
    """The b1 mma rate in operations per second (median of 5 launches of
    4 blocks per SM x 8 warps x 4 chains x 2048 mmas), set as the peak of
    kind "b1"."""
    lib, proc = build
    _, err = proc.communicate()
    check(proc.returncode == 0, f"nvcc of the b1 rate loop failed\n{err}")
    fn = ctypes.CDLL(str(lib)).b1_mma_loop_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks, iters = 4 * torch.cuda.get_device_properties(0).multi_processor_count, 2048
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")

    def run():
        check(fn(out.data_ptr(), blocks, iters, torch.cuda.current_stream().cuda_stream) == 0,
              "b1 rate loop launch failed")

    ms = statistics.median(p50_ms(run, 1) for _ in range(5))
    rate = blocks * 8 * iters * 4 * B1_OPS_PER_MMA / (ms * 1e-3)
    PEAK_OPS_PER_S["b1"] = rate
    print(f"[build] binary tensor cores (mma.sync m16n8k256 b1 AND+POPC): {rate / 1e12:.1f} TOP/s "
          f"measured ({ms:.4f} ms for {blocks * 8 * iters * 4:,} mmas)  ({gpu})", flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def entry(err, ms, plain_ms, n_bytes, ops, kind, nearest=None, nearest_ms=None):
    """One kernel's record: its error and times, and its bound, the larger
    of ``n_bytes`` over the memory rate and ``ops`` over the peak rate of
    ``kind``."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "library_ms": None, "nearest_route": nearest, "nearest_ms": nearest_ms,
    }


def int8_scan_bytes(q_count, n_valid, out_bytes):
    """Bytes an int8 scan must move: the valid rows and their scales, the
    queries, and its output."""
    return n_valid * (DIM + 4) + q_count * DIM + out_bytes


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if len(out) > 1 else out[0]


def p50_ms(fn, reps):
    """Median CUDA-event time of ``fn`` over ``reps`` launches (after one
    warm-up); each launch timed on its own."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextmanager
def plain_kernels(mods):
    """Route every search through the plain versions (on the same CUDA
    tensors) for the comparison; the kernels' counters do not move."""
    ops, tops, hops = mods
    swaps = [
        (ops, "int8_scores", ops._int8_scores_plain),
        (ops, "int8_candidates_packed", ops._int8_candidates_packed_plain),
        (ops, "int8_candidates", ops._int8_candidates_plain),
        (tops, "topk_tiles", tops._topk_tiles_plain),
        (hops, "binary_scores", hops._binary_scores_plain),
        (hops, "binary_topk_q1", hops._binary_topk_plain),
        (hops, "binary_topk_batched", hops._binary_topk_plain),
    ]
    saved = [(module, name, getattr(module, name)) for module, name, _ in swaps]
    for module, name, plain in swaps:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for module, name, kernel in saved:
            setattr(module, name, kernel)


def ordered(scores, rows):
    """Each row of (Q, k) results is ordered (score desc, row asc)."""
    a, b = scores[:, :-1], scores[:, 1:]
    return bool(((a > b) | ((a == b) & (rows[:, :-1] < rows[:, 1:]))).all())


def phase_kernels(mods, gpu, variants):
    """Phase 3, the dense kernels: returns ({kernel name: its record}, the
    resident (bf16 rows, int8 matrix, scales), which phase 8 searches)."""
    ops, tops, _ = mods
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rows = torch.empty((N_ROWS, DIM), dtype=torch.bfloat16, device=dev)
    for s in range(0, N_ROWS, 65536):
        x = torch.from_numpy(rng.standard_normal((min(65536, N_ROWS - s), DIM), dtype=np.float32))
        x = x.to(dev)
        rows[s : s + len(x)] = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    n_pad = -(-N_ROWS // ops.INT8_TILE_N) * ops.INT8_TILE_N
    m, scales = ops.derive_int8_matrix(rows, n_pad)
    queries = torch.from_numpy(rng.standard_normal((64, DIM), dtype=np.float32)).to(dev)
    queries = queries / torch.linalg.vector_norm(queries, dim=1, keepdim=True)
    torch.cuda.synchronize()
    print(f"[kernels] {N_ROWS:,} x {DIM} rows resident: bf16 {rows.numel() * 2 / 1e9:.2f} GB, "
          f"int8 {m.numel() / 1e9:.2f} GB (n_pad {n_pad:,})", flush=True)

    record = {}
    tiles = n_pad // ops.PACKED_TILE_N
    k_tile = min(128, max(4 * K, 2 * (-(-512 // tiles))))
    for q_count in (1, 16, 64):
        qi, _ = ops.quantize_queries(queries[:q_count])
        got = ops.int8_scores(qi, m, scales, N_ROWS)
        want = ops._int8_scores_plain(qi, m, scales, N_ROWS)
        check(torch.equal(got, want), f"int8_scores Q={q_count} differs from its plain version")
        err = (got - want).nan_to_num(0.0).abs().max().item()
        ms = p50_ms(lambda: ops.int8_scores(qi, m, scales, N_ROWS), 20)
        plain = p50_ms(lambda: ops._int8_scores_plain(qi, m, scales, N_ROWS), 5)
        print(f"[kernels] int8_scores Q={q_count}: bit-equal, p50 {ms:.4f} ms vs plain "
              f"{plain:.4f} ms  ({gpu})", flush=True)
        if q_count == 1:  # the single-query main path
            record["int8_scores"] = entry(
                err, ms, plain, int8_scan_bytes(1, N_ROWS, n_pad * 4), 2 * N_ROWS * DIM, "int8")
    k_pad = -(-k_tile // 128) * 128
    for q_count in (16, 64):
        qi, _ = ops.quantize_queries(queries[:q_count])
        args = (qi, m, scales, k_tile, N_ROWS, ops.PACKED_TILE_N)
        got = ops.int8_candidates_packed(*args)
        want = ops._int8_candidates_packed_plain(*args)
        check(torch.equal(got, want), f"int8_candidates_packed Q={q_count} keys differ")
        err = (got.long() - want.long()).abs().max().item()
        ms = p50_ms(lambda: ops.int8_candidates_packed(*args), 20)
        plain = p50_ms(lambda: ops._int8_candidates_packed_plain(*args), 5)
        # Nearest PyTorch route: kernel 1's scores, then torch.topk per tile
        # (the values, without the packed keys).
        nearest = p50_ms(lambda: torch.topk(ops.int8_scores(qi, m, scales, N_ROWS).view(
            q_count, tiles, ops.PACKED_TILE_N), k_tile, dim=-1), 20)
        print(f"[kernels] int8_candidates_packed Q={q_count} k_tile={k_tile}: keys bit-equal, "
              f"p50 {ms:.4f} ms vs plain {plain:.4f} ms; kernel 1 + per-tile torch.topk "
              f"{nearest:.4f} ms  ({gpu})", flush=True)
        if q_count == 16:
            record["int8_candidates_packed"] = entry(
                err, ms, plain, int8_scan_bytes(q_count, N_ROWS, q_count * tiles * k_pad * 4),
                2 * q_count * N_ROWS * DIM, "int8", "int8_scores + per-tile torch.topk", nearest)
    record["int8_candidates"] = phase_int8_candidates(mods, gpu, m, scales, queries)
    for q_count in (1, 16):
        q = queries[:q_count]

        def fused():
            return ops.topk_int8_rerank_fused_auto(q, m, scales, rows, K, n_valid=N_ROWS)

        s, i = fused()
        with plain_kernels(mods):
            s_plain, i_plain = fused()
        check(torch.equal(i, i_plain), f"fused search Q={q_count}: ids differ from the plain route")
        err = (s - s_plain).abs().max().item()
        check(err <= 1e-6, f"fused search Q={q_count}: scores differ by {err}")
        ms = p50_ms(fused, 20)
        print(f"[kernels] fused int8 search Q={q_count} k={K}: ids identical to the plain route, "
              f"max score diff {err:.2e}, p50 {ms:.4f} ms  ({gpu})", flush=True)
    if variants.get("int8_scan.cu"):
        phase_ab(ops, gpu, variants["int8_scan.cu"], m, scales, queries, rows)

    # Kernel 4 on the same bf16 rows: scores accumulate in fp32 in another
    # order than the plain float64 sum, so near-tie rows may swap. Beside
    # the wrapper (kernel + merge), the kernel's own launch.
    own = thin_topk_tiles(_build_library())
    for q_count in (1, 16):
        q = queries[:q_count]
        for k in (K, 128):
            s, i = tops.topk_tiles(q, rows, k, N_ROWS)
            s_p, i_p = tops._topk_tiles_plain(q, rows, k, N_ROWS)
            err = (s - s_p).abs().max().item()
            check(err <= 1e-5, f"topk_tiles Q={q_count} k={k}: scores off the plain version by {err}")
            plain_of = tops._scores_plain(q, rows, N_ROWS).gather(1, i)
            check(bool((plain_of >= s_p[:, -1:] - 1e-5).all()),
                  f"topk_tiles Q={q_count} k={k}: a row below the plain k-th score")
            check(ordered(s, i), f"topk_tiles Q={q_count} k={k}: not ordered (score desc, row asc)")
            diff = (i != i_p).nonzero().tolist()
            ms = p50_ms(lambda: tops.topk_tiles(q, rows, k, N_ROWS), 20)
            kernel_ms = p50_ms(own(q, rows, k, N_ROWS), 20)
            plain = p50_ms(lambda: tops._topk_tiles_plain(q, rows, k, N_ROWS), 3)
            # Nearest PyTorch route: one bf16 GEMM (bf16 scores), then torch.topk.
            nearest = p50_ms(lambda: torch.topk(q.to(torch.bfloat16) @ rows.T, k, dim=1), 10)
            ids = "ids identical" if not diff else (
                f"{len(diff)} id positions differ (near ties), first {[(p, int(i[p[0], p[1]]), int(i_p[p[0], p[1]])) for p in diff[:5]]}"
            )
            print(f"[kernels] topk_tiles Q={q_count} k={k}: {ids}, max score diff {err:.2e}, "
                  f"p50 {ms:.4f} ms (the kernel's own launch {kernel_ms:.4f} ms) vs plain {plain:.4f} ms; "
                  f"bf16 matmul + torch.topk {nearest:.4f} ms  ({gpu})", flush=True)
            if q_count == 1 and k == K:  # the single-query bf16 search
                record["topk_tiles"] = entry(
                    err, ms, plain, N_ROWS * DIM * 2 + q_count * DIM * 4 + q_count * k * 12,
                    2 * q_count * N_ROWS * DIM, "bf16", "bf16 torch.matmul + torch.topk", nearest)
                record["topk_tiles"]["kernel_ms"] = kernel_ms
    if variants.get("topk_bf16.cu"):
        cases = [(f"kernel 4 Q={q_count} k={k}", q_count, k)
                 for q_count, k in ((1, K), (1, 128), (16, K), (16, 128), (64, K))]
        time_turns(gpu, [(name, {label: prepare(queries[:q_count], rows, k, N_ROWS)
                                 for label, prepare in variants["topk_bf16.cu"]})
                         for name, q_count, k in cases], close_scores)

    # k = 128 with the top 128 rows at local positions 0 and 1 mod 32 of
    # one tile, the best 64 at 0: the selection warp's lane 0 runs out of
    # untaken slots halfway, and must still join every shuffle.
    small = 0.1 * torch.nn.functional.normalize(torch.randn(
        (2 * tops.DEFAULT_TILE_N, DIM), generator=torch.Generator().manual_seed(5)), dim=1)
    q = queries[:1].cpu()
    planted = [tops.DEFAULT_TILE_N + 32 * j + r for r in (0, 1) for j in range(tops.DEFAULT_TILE_N // 32)]
    for rank, row in enumerate(planted):
        small[row] = (1.0 - rank / 200.0) * q[0]
    small = small.to(torch.bfloat16).to(dev)
    s, i = tops.topk_tiles(q.to(dev), small, 128, len(small))
    s_p, _ = tops._topk_tiles_plain(q.to(dev), small, 128, len(small))
    err = (s - s_p).abs().max().item()
    check(sorted(i[0].tolist()) == sorted(planted) and err <= 1e-5 and ordered(s, i),
          f"topk_tiles with lanes out of slots: wrong rows or scores off by {err}")
    print(f"[kernels] topk_tiles k=128, 64 of the top rows in each of two lanes' slots: the planted "
          f"rows, ordered, max score diff {err:.2e}", flush=True)

    # The bf16 route above k = 128 (no kernel in tpuclip either): a chunked
    # fp32 matmul and the exact selection, against kernel 4's float64 reference.
    for q_count in (1, 16):
        q = queries[:q_count]
        s, i = tops.topk_plain(q, rows, 200, N_ROWS)
        s_p, _ = tops._topk_tiles_plain(q, rows, 200, N_ROWS)
        err = (s - s_p).abs().max().item()
        check(err <= 1e-5 and ordered(s, i), f"topk_plain Q={q_count} k=200: scores off by {err}")
        ms = p50_ms(lambda: tops.topk_plain(q, rows, 200, N_ROWS), 10)
        print(f"[kernels] topk_plain (bf16 route, k > 128) Q={q_count} k=200: max score diff {err:.2e} "
              f"from the float64 reference, p50 {ms:.4f} ms  ({gpu})", flush=True)
    return record, (rows, m, scales)


def phase_int8_candidates(mods, gpu, m, scales, queries):
    """Phase 3, kernel 3 on the 1M int8 matrix, then ``quantize_matrix``:
    returns kernel 3's (max_abs_err, ms, plain_ms) at Q = 1, k_tile = 80,
    the single-query shortlist of a top-20 search without the rerank copy."""
    ops = mods[0]
    dev = m.device
    tile = ops.PACKED_TILE_N

    def same(got, want):
        return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    record = None
    tiles = m.shape[0] // tile
    for q_count, k_tile in ((1, 20), (1, 80), (1, 128), (16, 80)):
        qi, _ = ops.quantize_queries(queries[:q_count])
        args = (qi, m, scales, k_tile, N_ROWS, tile)
        got = ops.int8_candidates(*args)
        want = ops._int8_candidates_plain(*args)
        check(same(got, want), f"int8_candidates Q={q_count} k_tile={k_tile} differs from its plain version")
        err = (got[0] - want[0]).nan_to_num(0.0).abs().max().item()  # -inf padding on both sides
        ms = p50_ms(lambda: ops.int8_candidates(*args), 20)
        plain = p50_ms(lambda: ops._int8_candidates_plain(*args), 3)
        # Nearest PyTorch route: kernel 1's scores, then torch.topk per tile
        # (ties in no defined order).
        nearest = p50_ms(lambda: torch.topk(ops.int8_scores(qi, m, scales, N_ROWS).view(
            q_count, tiles, tile), k_tile, dim=-1), 20)
        print(f"[kernels] int8_candidates Q={q_count} k_tile={k_tile}: scores and rows bit-equal, "
              f"p50 {ms:.4f} ms vs plain {plain:.4f} ms; kernel 1 + per-tile torch.topk "
              f"{nearest:.4f} ms  ({gpu})", flush=True)
        if (q_count, k_tile) == (1, 80):
            k_pad = -(-k_tile // 128) * 128
            record = entry(err, ms, plain, int8_scan_bytes(q_count, N_ROWS, q_count * tiles * k_pad * 8),
                           2 * q_count * N_ROWS * DIM, "int8", "int8_scores + per-tile torch.topk", nearest)

    # Ties, on a copy: tile 3's top 128 rows are the query's own int8 row at
    # local positions 0 and 1 mod 32, in pairs of equal scales, so the
    # selection lanes 0 and 1 run out of untaken slots halfway through
    # k_tile = 128 rounds; tile 7 holds three copies of that row.
    qi, _ = ops.quantize_queries(queries[:1])
    mp, sp = m.clone(), scales.clone()
    lanes = [3 * tile + 32 * j + r for j in range(64) for r in (0, 1)]
    copies = [7 * tile + 5, 7 * tile + 700, 7 * tile + 1500]
    mp[lanes + copies] = qi[0]
    sp[lanes] = torch.tensor([1.0 - 1e-3 * (i // 2) for i in range(128)], device=dev)
    sp[copies] = 0.5
    got = ops.int8_candidates(qi, mp, sp, 128, N_ROWS, tile)
    want = ops._int8_candidates_plain(qi, mp, sp, 128, N_ROWS, tile)
    check(same(got, want), "int8_candidates with planted ties differs from its plain version")
    s, i = got[0].view(-1, 128), got[1].view(-1, 128)
    check(i[3].tolist() == lanes and torch.equal(s[3, 0::2], s[3, 1::2]),
          "int8_candidates: tile 3's planted rows are not its top 128, ordered (score desc, row asc)")
    check(i[7, :3].tolist() == copies and bool((s[7, :3] == s[7, 0]).all()),
          "int8_candidates: tile 7's three copies are not its top 3 in row order")
    del mp, sp
    print("[kernels] int8_candidates k_tile=128 with planted ties (64 pairs of equal scores in two "
          "lanes' slots, three copies of one row): bit-equal, the planted rows in (score desc, row asc) "
          "order", flush=True)

    # topk_int8 (kernel 3 + merge + x q_scale) against the route through the
    # plain version, at the host route's shortlist for k = 20.
    qi, qs = ops.quantize_query(queries[0].cpu().numpy())
    qi = qi.to(dev)

    def route():
        return ops.topk_int8(qi, m, scales, qs, 4 * K, N_ROWS)

    s, i = route()
    ms = p50_ms(route, 20)
    # The yardstick: kernel 1's full scores, then torch.topk over them.
    yardstick = p50_ms(lambda: torch.topk(ops.int8_scores(qi, m, scales, N_ROWS), 4 * K, dim=1), 20)
    with plain_kernels(mods):
        s_p, i_p = route()
        plain = p50_ms(route, 3)
    check(torch.equal(i, i_p) and torch.equal(s, s_p), "topk_int8 differs from the plain route")
    print(f"[kernels] topk_int8 Q=1 k={4 * K}: ids identical and scores bit-equal to the plain route, "
          f"p50 {ms:.4f} ms vs plain route {plain:.4f} ms; kernel 1 + torch.topk over "
          f"{m.shape[0]:,} scores {yardstick:.4f} ms  ({gpu})", flush=True)

    # quantize_matrix: fp32 rows -> int8 by true divisions, as numpy does.
    chunk = np.random.default_rng(7).standard_normal((65536, DIM), dtype=np.float32)
    qm, qsc = ops.quantize_matrix(chunk, len(chunk), dev)
    want_sc = np.abs(chunk).max(1) / np.float32(127)
    want_q = np.clip(np.rint(chunk / want_sc[:, None]), -127, 127).astype(np.int8)
    check(np.array_equal(qsc.cpu().numpy(), want_sc) and np.array_equal(qm.cpu().numpy(), want_q),
          "quantize_matrix differs from numpy's true-division quantization")
    print(f"[kernels] quantize_matrix {len(chunk):,} x {DIM} fp32 rows: int8 values and scales "
          f"bit-equal to numpy", flush=True)
    return record


def stream():
    return torch.cuda.current_stream().cuda_stream


def _build_library():
    from tpuclip_torch.ops import _build

    return _build.library()


def thin_wrappers(lib):
    """Kernels 2 and 3 of one built library as (packed, candidates), with
    the wrappers' signatures and output layout but none of their checks, so
    that every build compared in the A/B pays the same host cost."""
    def packed(q_int8, m_int8, scales, k_tile, n_valid, tile):
        k_pad = -(-k_tile // 128) * 128
        out = torch.empty((q_int8.shape[0], m_int8.shape[0] // tile * k_pad), dtype=torch.int32,
                          device=q_int8.device)
        rc = lib.tpuclip_int8_candidates_packed(
            q_int8.data_ptr(), m_int8.data_ptr(), scales.data_ptr(), out.data_ptr(), q_int8.shape[0],
            m_int8.shape[0], q_int8.shape[1], int(n_valid), tile, k_tile, k_pad, stream())
        check(rc == 0, f"int8_candidates_packed launch failed: cudaError {rc}")
        return out

    def candidates(q_int8, m_int8, scales, k_tile, n_valid, tile):
        k_pad = -(-k_tile // 128) * 128
        shape = (q_int8.shape[0], m_int8.shape[0] // tile * k_pad)
        out_s = torch.empty(shape, dtype=torch.float32, device=q_int8.device)
        out_i = torch.empty(shape, dtype=torch.int32, device=q_int8.device)
        rc = lib.tpuclip_int8_candidates(
            q_int8.data_ptr(), m_int8.data_ptr(), scales.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), q_int8.shape[0], m_int8.shape[0], q_int8.shape[1], int(n_valid), tile,
            k_tile, k_pad, stream())
        check(rc == 0, f"int8_candidates launch failed: cudaError {rc}")
        return out_s, out_i

    return packed, candidates


def thin_binary_wrappers(lib, hops):
    """Kernels 6 and 7 of one built library as (q1, batched), called as the
    wrappers call them (this tree's chunking, one call for all queries) but
    without their checks. An older build of the same C signature reads the
    head of the same scratch as its histogram (the previous design's
    (Q, chunks + 1, bins) int32 counts, as many as this one's)."""
    def call(entry, q, words, k, n_valid):
        n, w = words.shape
        sms = torch.cuda.get_device_properties(words.device).multi_processor_count
        chunk_rows, group, n_bytes = hops._binary_plan(q.shape[0], n, w, sms)
        check(group == q.shape[0], "the A/B runs every query in one kernel call")
        scratch = torch.empty(n_bytes, dtype=torch.uint8, device=words.device)
        out_m = torch.empty((q.shape[0], k), dtype=torch.int32, device=words.device)
        out_r = torch.empty((q.shape[0], k), dtype=torch.int64, device=words.device)
        args = [q.data_ptr(), words.data_ptr(), scratch.data_ptr(), out_m.data_ptr(), out_r.data_ptr()]
        if entry == "tpuclip_binary_topk":
            args.append(q.shape[0])
        rc = getattr(lib, entry)(*args, n, w, int(n_valid), k, chunk_rows, stream())
        check(rc == 0, f"{entry} launch failed: cudaError {rc}")
        return out_m, out_r

    return (lambda q, words, k, n_valid: call("tpuclip_binary_topk_q1", q, words, k, n_valid),
            lambda q, words, k, n_valid: call("tpuclip_binary_topk", q, words, k, n_valid))


def thin_topk_tiles(lib):
    """Kernel 4 of one built library: ``prepare(q, rows, k, n_valid)``
    allocates the (Q, tiles * k) candidates once and returns the launch
    alone, which returns them (both builds share the C signature)."""
    def prepare(q, rows, k, n_valid):
        q = q.to(torch.bfloat16).contiguous()
        tiles = -(-rows.shape[0] // 2048)
        out_s = torch.empty((q.shape[0], tiles * k), dtype=torch.float32, device=q.device)
        out_i = torch.empty((q.shape[0], tiles * k), dtype=torch.int32, device=q.device)

        def run():
            rc = lib.tpuclip_topk_tiles(q.data_ptr(), rows.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
                                        q.shape[0], rows.shape[0], q.shape[1], int(n_valid), 2048, k, stream())
            check(rc == 0, f"topk_tiles launch failed: cudaError {rc}")
            return out_s, out_i
        return run
    return prepare


def thin_patch_embed(lib, current):
    """Kernel 8 of one built library: ``prepare(x, w, b)`` allocates the
    bf16 out once and returns the launch alone. A build with this tree's C
    signature (``current``) reads the (K, D) weights and the bias as given;
    an older one (x, wt, bias, out, rows, k, k_pad, d, out_f32) gets its
    K-major zero-padded weight copy and f32 bias made here, outside the
    timed launch."""
    def prepare(x, w, b):
        rows, k = x.shape
        d = w.shape[1]
        out = torch.empty((rows, d), dtype=torch.bfloat16, device=x.device)
        if current:
            args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), rows, k, d, 0,
                    int(b.dtype == torch.bfloat16))
            keep = ()
        else:
            k_pad = -(-k // 64) * 64
            wt = torch.zeros((d, k_pad), dtype=torch.bfloat16, device=x.device)
            wt[:, :k] = w.t()
            b32 = b.float().contiguous()
            args = (x.data_ptr(), wt.data_ptr(), b32.data_ptr(), out.data_ptr(), rows, k, k_pad, d, 0)
            keep = (wt, b32)

        def run():
            rc = lib.tpuclip_patch_embed(*args, stream())
            check(rc == 0, f"patch_embed launch failed: cudaError {rc}")
            return out
        run.tensors = (out, *keep)  # alive as long as the launch
        return run
    return prepare


# Entry points of each source that --ab can take, and their thin wrappers
# (made from a library, the hamming module and whether the library takes
# this tree's C signatures).
AB_SOURCES = {
    "int8_scan.cu": (("tpuclip_int8_candidates_packed", "tpuclip_int8_candidates"),
                     lambda lib, hops, current: thin_wrappers(lib)),
    "binary_scan.cu": (("tpuclip_binary_topk_q1", "tpuclip_binary_topk"),
                       lambda lib, hops, current: thin_binary_wrappers(lib, hops)),
    "topk_bf16.cu": (("tpuclip_topk_tiles",), lambda lib, hops, current: thin_topk_tiles(lib)),
    "patch_embed.cu": (("tpuclip_patch_embed",), lambda lib, hops, current: thin_patch_embed(lib, current)),
}


def entry_points(path):
    """The C signatures a kernel source exports, as text: equal for two
    builds that take the same arguments."""
    import re

    return re.findall(r"^int (tpuclip_\w+\([^)]*\))", Path(path).read_text(), flags=re.M)


def build_variants(specs, hops):
    """Each ``LABEL:PATH`` built into build/ab/libLABEL_STEM.so (one nvcc each,
    all together); the file name says which kernels it holds
    (``AB_SOURCES``). Returns {file name: [(label, thin wrappers)]}, this
    tree's own library first as "this"."""
    from tpuclip_torch.ops import _build

    out_dir = _build.BUILD_DIR.parent / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for spec in specs:
        label, path = spec.split(":", 1)
        source = Path(path).name
        check(source in AB_SOURCES, f"--ab {spec}: not one of {sorted(AB_SOURCES)}")
        lib = out_dir / f"lib{label}_{Path(path).stem}.so"  # one label may name several sources
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), path]
        jobs.append((spec, label, source, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                                stderr=subprocess.PIPE, text=True)))
    this = _build.library()
    variants = {}
    for spec, label, source, lib, proc in jobs:
        _, err = proc.communicate()
        check(proc.returncode == 0, f"--ab {label}: nvcc failed\n{err}")
        handle = ctypes.CDLL(str(lib))
        names, wrap = AB_SOURCES[source]
        for name in names:
            fn = getattr(handle, name)
            fn.argtypes = _build.SIGNATURES[name]
            fn.restype = ctypes.c_int
        if source not in variants:
            variants[source] = [("this", wrap(this, hops, True))]
        current = entry_points(spec.split(":", 1)[1]) == entry_points(_build.SOURCES[0].parent / source)
        variants[source].append((label, wrap(handle, hops, current)))
        print(f"[ab] built {label} from {spec}", flush=True)
    return variants


def same_output(a, b):
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def bit_equal(a, b):
    """The A/B comparison of the exact kernels: bit-equal or fail."""
    return same_output(a, b), "bit-equal"


def close_scores(a, b):
    """The A/B comparison of kernel 4, whose fp32 sums may differ in the
    last bits between builds: bit-equal, or the candidates' scores within
    1e-5, with the max difference told."""
    if same_output(a, b):
        return True, "bit-equal"
    err = (a[0] - b[0]).nan_to_num(0.0).abs().max().item()  # -inf padding on both sides
    return err <= 1e-5, f"max score diff {err:.2e}"


def within_bf16_step(a, b):
    """The A/B comparison of kernel 8's bf16 out: bit-equal, or each value
    within one bf16 step of the other build's, with the max difference
    told."""
    if torch.equal(a, b):
        return True, "bit-equal"
    x, y = a.float(), b.float()
    _, exp = torch.frexp(y)
    err = (x - y).abs()
    return bool((err <= torch.ldexp(torch.ones_like(y), exp - 8)).all()), f"max diff {err.max().item():.2e}"


def time_turns(gpu, cases, compare=bit_equal):
    """Each case is (name, {label: callable}), "this" among the labels: every
    other build's output must pass ``compare`` against this tree's; then
    each is timed in turns: the others, this, this, the others in reverse
    (p50 of 20 launches each). Prints one line per case and one JSON line of
    every time."""
    results = {}
    for name, runs in cases:
        want = runs["this"]()
        order = [label for label in runs if label != "this"]
        notes = []
        for label in order:
            ok, note = compare(runs[label](), want)
            check(ok, f"[ab] {name}: {label} differs from this tree ({note})")
            notes.append(f"{label} {note}")
        del want
        times = {}
        for label in order + ["this", "this"] + order[::-1]:
            times.setdefault(label, []).append(p50_ms(runs[label], 20))
        results[name] = times
        turns = ", ".join(f"{label} {' / '.join(f'{t:.4f}' for t in ts)} ms" for label, ts in times.items())
        print(f"[ab] {name}: {turns}; outputs: {', '.join(notes)}  ({gpu})", flush=True)
    print("[ab-json] " + json.dumps({"gpu": gpu, "ms": results}), flush=True)


def ab_turns(ops, gpu, variants, cases):
    """:func:`time_turns` over int8 builds: each case's callable is made from
    a build's (packed, candidates); the fused search and topk_int8 reach the
    build's kernels through the module's names, swapped for the call."""
    def route(packed, candidates, make):
        fn = make(packed, candidates)

        def run():
            saved = ops.int8_candidates_packed, ops.int8_candidates
            ops.int8_candidates_packed, ops.int8_candidates = packed, candidates
            try:
                return fn()
            finally:
                ops.int8_candidates_packed, ops.int8_candidates = saved
        return run

    time_turns(gpu, [(name, {label: route(*fns, make) for label, fns in variants})
                     for name, make in cases])


def phase_ab(ops, gpu, variants, m, scales, queries, rows):
    """Phase 3 with ``--ab``: kernels 2 and 3 of every build at the 1M-row
    cases of PERF.md's predictions, and the two routes that run them."""
    tile = ops.PACKED_TILE_N
    q16, _ = ops.quantize_queries(queries[:16])
    q64, _ = ops.quantize_queries(queries[:64])
    q1, qs1 = ops.quantize_query(queries[0].cpu().numpy())
    q1 = q1.to(m.device)
    cases = [
        (f"kernel 3 Q=1 k_tile={k}", lambda p, c, k=k: lambda: c(q1, m, scales, k, N_ROWS, tile))
        for k in (20, 80, 128)
    ]
    cases += [
        ("kernel 3 Q=16 k_tile=80", lambda p, c: lambda: c(q16, m, scales, 80, N_ROWS, tile)),
        ("kernel 2 Q=16 k_tile=80", lambda p, c: lambda: p(q16, m, scales, 80, N_ROWS, tile)),
        ("kernel 2 Q=64 k_tile=80", lambda p, c: lambda: p(q64, m, scales, 80, N_ROWS, tile)),
        (f"fused int8 search Q=16 k={K}", lambda p, c: lambda: ops.topk_int8_rerank_fused_auto(
            queries[:16], m, scales, rows, K, n_valid=N_ROWS)),
        (f"topk_int8 Q=1 k={4 * K}", lambda p, c: lambda: ops.topk_int8(q1, m, scales, qs1, 4 * K, N_ROWS)),
    ]
    ab_turns(ops, gpu, variants, cases)


def phase_int8_4m(ops, gpu, variants):
    """Phase 3, kernel 3 where its route is the default: Q = 1, k_tile = 80
    on 4M x 1152 int8 rows made on the card, bit-equal to its plain
    version, beside the two-call route (kernel 1 + torch.topk)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    n_pad = -(-N_ROWS_4M // ops.INT8_TILE_N) * ops.INT8_TILE_N
    m = torch.empty((n_pad, DIM), dtype=torch.int8, device=dev)
    for s in range(0, n_pad, 262144):
        e = min(n_pad, s + 262144)
        m[s:e] = torch.randint(-127, 128, (e - s, DIM), generator=gen, device=dev, dtype=torch.int32)
    # Per-row scales of unit-norm rows (max|x| / 127 lies near 1 / 1270).
    scales = (torch.rand(n_pad, generator=gen, device=dev) * 0.5 + 0.5) / 1270.0
    q, q_scale = ops.quantize_query(np.random.default_rng(9).standard_normal(DIM).astype(np.float32))
    q = q.to(dev)
    tile = ops.PACKED_TILE_N
    args = (q, m, scales, 4 * K, N_ROWS_4M, tile)
    got, want = ops.int8_candidates(*args), ops._int8_candidates_plain(*args)
    check(same_output(got, want), "int8_candidates at 4M rows differs from its plain version")
    ms = p50_ms(lambda: ops.int8_candidates(*args), 20)
    plain = p50_ms(lambda: ops._int8_candidates_plain(*args), 3)
    route = p50_ms(lambda: ops.topk_int8(q, m, scales, q_scale, 4 * K, N_ROWS_4M), 20)
    yardstick = p50_ms(lambda: torch.topk(ops.int8_scores(q, m, scales, N_ROWS_4M), 4 * K, dim=1), 20)
    k_pad = 128
    bound = entry(0.0, ms, plain, int8_scan_bytes(1, N_ROWS_4M, n_pad // tile * k_pad * 8),
                  2 * N_ROWS_4M * DIM, "int8")["bound_ms"]
    print(f"[kernels] int8_candidates Q=1 k_tile={4 * K} on {N_ROWS_4M:,} x {DIM} int8 rows "
          f"({m.numel() / 1e9:.2f} GB, n_pad {n_pad:,}): bit-equal, p50 {ms:.4f} ms (bound {bound:.4f} ms) "
          f"vs plain {plain:.4f} ms; topk_int8 k={4 * K} {route:.4f} ms vs kernel 1 + torch.topk "
          f"{yardstick:.4f} ms  ({gpu})", flush=True)
    if variants:
        ab_turns(ops, gpu, variants, [
            (f"kernel 3 Q=1 k_tile={4 * K} at 4M rows", lambda p, c: lambda: c(*args)),
        ])
    del m, scales


def phase_patch_embed(pops, gpu, variants):
    """Phase 3, kernel 8 at SO400M's patch shape: returns its record in bf16
    out, the library function's default; with ``--ab``, every build of
    patch_embed.cu in turns."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    pix = torch.from_numpy(rng.integers(0, 256, (64, 224, 224, 3), dtype=np.uint8)).to(dev)
    x = pops.patches_from_images_u8(pix, 14).contiguous()
    w = torch.from_numpy((rng.standard_normal((588, DIM)) * 0.02).astype(np.float32)).to(dev)
    w = w.to(torch.bfloat16)
    b = torch.from_numpy((rng.standard_normal(DIM) * 0.02).astype(np.float32)).to(dev).to(torch.bfloat16)
    check(x.shape == (64 * 256, 588), f"patch rows {tuple(x.shape)}")
    # f32 out: every product of bf16 values is exact in f32, so the kernel
    # and the float64 plain version differ only by the order of 588 f32
    # additions of values below 2.
    got = pops.patch_embed_fused(x, w, b, torch.float32)
    want = pops._patch_embed_plain(x, w, b, torch.float32)
    err32 = (got - want).abs().max().item()
    check(err32 <= 1e-5, f"patch_embed_fused f32 out off the plain version by {err32}")
    # bf16 out: the f32 value above, rounded to nearest even; so at most one
    # bf16 step (2**-7 of the power of two below) plus the f32 tolerance from
    # the plain version's bf16 out (near zero the step is below the f32 error).
    got_f32 = got
    got = pops.patch_embed_fused(x, w, b)
    check(torch.equal(got, got_f32.to(torch.bfloat16)), "patch_embed_fused bf16 out is not its f32 out rounded")
    got, want = got.float(), pops._patch_embed_plain(x, w, b).float()
    _, exp = torch.frexp(want)
    step = torch.ldexp(torch.ones_like(want), exp - 8)
    err = (got - want).abs()
    check(bool((err <= step + 1e-5).all()), "patch_embed_fused bf16 out more than one bf16 step off the plain version")
    err = err.max().item()
    rows = x.shape[0]
    ms = p50_ms(lambda: pops.patch_embed_fused(x, w, b), 20)
    kernel_ms = p50_ms(thin_patch_embed(_build_library(), True)(x, w, b), 20)
    plain = p50_ms(lambda: pops._patch_embed_plain(x, w, b), 3)
    # The tower's own route: normalise to bf16, then cuBLAS's bf16 GEMM.
    from tpuclip_torch.models.siglip import normalize_pixels

    wt = w.t().contiguous()
    xn = pops.patches_from_images_u8(normalize_pixels(pix, torch.bfloat16), 14).contiguous()
    gemm = p50_ms(lambda: torch.nn.functional.linear(xn, wt, b), 20)
    both = p50_ms(lambda: torch.nn.functional.linear(
        pops.patches_from_images_u8(normalize_pixels(pix, torch.bfloat16), 14), wt, b), 20)
    gflop = 2 * x.shape[0] * 588 * DIM / 1e9
    print(f"[kernels] patch_embed_fused R={x.shape[0]:,} x 588 -> {DIM}: f32 out max diff {err32:.2e}, "
          f"bf16 out within one bf16 step (max diff {err:.2e}); p50 {ms:.4f} ms ({gflop / ms:.1f} "
          f"TFLOP/s; the kernel's own launch {kernel_ms:.4f} ms, {gflop / kernel_ms:.1f} TFLOP/s) vs plain "
          f"{plain:.4f} ms; the tower's cuBLAS F.linear on normalised bf16 rows "
          f"{gemm:.4f} ms, with the normalisation {both:.4f} ms  ({gpu})", flush=True)
    if variants:
        time_turns(gpu, [(f"kernel 8 R={rows:,} bf16 out", {label: prepare(x, w, b) for label, prepare in variants})],
                   within_bf16_step)
    return {**entry(err, ms, plain, rows * 588 + 588 * DIM * 2 + DIM * 2 + rows * DIM * 2,
                    2 * rows * 588 * DIM, "bf16", "normalise to bf16 + F.linear", both),
            "kernel_ms": kernel_ms}


def phase_binary_kernels(hops, gpu, variants):
    """Phase 3, the binary kernels on 10M packed rows of random bits (dense
    ties): returns {kernel name: its record}; kernel 7 has two, at Q = 4,
    k = 640 (a cascade batch at its default depth) and at Q = 16, k = 20."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def random_words(n):
        return torch.randint(-(2**31), 2**31, (n, WORDS), generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    words, n_valid = hops.pad_words(random_words(N_BINARY))
    queries = random_words(64)
    torch.cuda.synchronize()
    n_pad = words.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[kernels] {N_BINARY:,} x {WORDS} packed words resident: "
          f"{words.numel() * 4 / 1e9:.2f} GB (n_pad {n_pad:,})", flush=True)
    record = {}
    q1 = queries[:1]
    got = hops.binary_scores(q1, words, n_valid)
    want = hops._binary_scores_plain(q1, words, n_valid)
    check(torch.equal(got, want), "binary_scores differs from its plain version")
    err = (got - want).nan_to_num(0.0).abs().max().item()  # -inf padding on both sides
    ms = p50_ms(lambda: hops.binary_scores(q1, words, n_valid), 10)
    plain = p50_ms(lambda: hops._binary_scores_plain(q1, words, n_valid), 3)
    print(f"[kernels] binary_scores Q=1: bit-equal, p50 {ms:.4f} ms vs plain {plain:.4f} ms  ({gpu})",
          flush=True)
    record["binary_scores"] = entry(err, ms, plain, n_valid * WORDS * 4 + WORDS * 4 + n_pad * 4,
                                    n_valid * WORDS, "popc")
    m = 2 * 640  # the cascade's single-query shortlist at k = 20 (depth 640)
    ms = p50_ms(lambda: hops.binary_shortlist_q1(q1, words, m, n_valid), 10)
    print(f"[kernels] binary_shortlist_q1 m={m}: p50 {ms:.4f} ms (kernel 5 + exact top-m over "
          f"{n_pad:,} keys)  ({gpu})", flush=True)
    # (wrapper, Q, k values, {(Q, k): record name}) of every case.
    cases = (
        ("binary_topk_q1", 1, (K, 640, 4096), {(1, K): "binary_topk_q1"}),
        ("binary_topk_batched", 4, (K, 640), {(4, 640): "binary_topk_batched"}),
        ("binary_topk_batched", 16, (K, 640), {(16, K): "binary_topk_batched_q16"}),
        ("binary_topk_batched", 64, (K,), {}),
    )
    for name, q_count, ks, keep in cases:
        kernel = getattr(hops, name)
        q = queries[:q_count]
        for k in ks:
            m, r = kernel(q, words, k, n_valid)
            m_p, r_p = hops._binary_topk_plain(q, words, k, n_valid)
            check(torch.equal(m, m_p) and torch.equal(r, r_p),
                  f"{name} Q={q_count} k={k}: matches or rows differ from the plain version")
            err = (m.long() - m_p.long()).abs().max().item()
            del m_p, r_p
            ms = p50_ms(lambda: kernel(q, words, k, n_valid), 10)
            plain = p50_ms(lambda: hops._binary_topk_plain(q, words, k, n_valid), 3)
            ties = int((m[:, :-1] == m[:, 1:]).sum())
            _, group, scratch = hops._binary_plan(q_count, n_pad, WORDS, sms)
            # Pass 1 runs on the binary tensor cores: an AND and an add per
            # (query, row, bit).
            bound = entry(err, ms, plain, n_valid * WORDS * 4 + q_count * WORDS * 4 + q_count * k * 12,
                          2 * q_count * n_valid * DIM, "b1")
            print(f"[kernels] {name} Q={q_count} k={k}: matches and rows identical "
                  f"({ties} tied neighbours), p50 {ms:.4f} ms (bound {bound['bound_ms']:.4f} ms, "
                  f"{bound['bound_by']}) vs plain {plain:.4f} ms; scratch {scratch:,} bytes in "
                  f"{-(-q_count // group)} call(s)  ({gpu})", flush=True)
            if (q_count, k) in keep:
                # Nearest PyTorch route: per-query popcount scores (kernel
                # 5), then torch.topk (ties in no defined order).
                nearest = p50_ms(lambda: [torch.topk(hops.binary_scores(q[j:j + 1], words, n_valid), k)
                                          for j in range(q_count)], 10)
                print(f"[kernels] {name} Q={q_count} k={k}: kernel 5 + torch.topk per query "
                      f"{nearest:.4f} ms  ({gpu})", flush=True)
                record[keep[(q_count, k)]] = {
                    **bound, "nearest_route": "binary_scores + torch.topk per query",
                    "nearest_ms": nearest}
    if variants:
        q4, q16 = queries[:4], queries[:16]
        runs = [(f"kernel 6 Q=1 k={k}", lambda q1f, bf, k=k: lambda: q1f(q1, words, k, n_valid))
                for k in (K, 640, 4096)]
        runs += [(f"kernel 7 Q={len(q)} k={k}", lambda q1f, bf, q=q, k=k: lambda: bf(q, words, k, n_valid))
                 for q, k in ((q4, 640), (q16, K), (queries, K))]
        time_turns(gpu, [(name, {label: make(*fns) for label, fns in variants}) for name, make in runs])
    return record


def write_jpegs(root, n):
    from PIL import Image

    rng = np.random.default_rng(1)
    for i in range(n):
        folder = root / f"set_{i // 128}"
        folder.mkdir(parents=True, exist_ok=True)
        base = rng.integers(0, 256, (1, 1, 3))
        noise = rng.integers(-40, 40, (192, 256, 3))
        arr = np.clip(base + noise, 0, 255).astype(np.uint8)
        Image.fromarray(arr).save(folder / f"img_{i:04d}.jpg", quality=90)


def brute_force(rows_bf16, q, k):
    """(score desc, row asc) top-k of fp32 dots of the bf16-rounded query
    with the bf16 rows: what the exact rescore returns."""
    qr = torch.from_numpy(q).to(torch.bfloat16).float()
    scores = (rows_bf16.float() * qr[None]).sum(-1).numpy()
    order = np.lexsort((np.arange(len(scores)), -scores))[:k]
    return order, scores[order]


def phase_end_to_end(mods, gpu, work):
    """Phase 4: returns (launches of kernels 1 and 2, database, model cache,
    engine)."""
    ops = mods[0]
    from tpuclip_torch import cli
    from tpuclip_torch.engine import ImageDatabase

    os.environ["TPUCLIP_HOME"] = str(work / "home")
    os.environ["TPUCLIP_INIT"] = "random"
    root, db, cache = work / "images", str(work / "smoke.db"), str(work / "models")
    write_jpegs(root, N_IMAGES)
    print(f"[e2e] wrote {N_IMAGES} JPEGs", flush=True)

    scan_seconds = []
    original_scan = ImageDatabase.scan_directory

    def timed_scan(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = original_scan(self, *args, **kwargs)
        torch.cuda.synchronize()
        scan_seconds.append(time.perf_counter() - t0)
        return out

    captured = []
    original_gallery = ImageDatabase.generate_html_gallery

    def capture_gallery(self, results, *args, **kwargs):
        captured.append(list(results))
        return original_gallery(self, results, *args, **kwargs)

    ImageDatabase.scan_directory = timed_scan
    ImageDatabase.generate_html_gallery = capture_gallery
    try:
        ops.int8_scores.launches = 0
        ops.int8_candidates_packed.launches = 0
        t0 = time.perf_counter()
        cli.main(["scan", str(root), "--db", db, "--model-cache", cache,
                  "--inference-batch-size", "64", "--profile"])
        scan_wall = time.perf_counter() - t0
        cli.main(["search", "a red car", "-k", str(K), "--db", db, "--model-cache", cache,
                  "--no-session"])
        engine = ImageDatabase(db, cache, inference_batch_size=64)
        texts = TEXTS
        batch = engine.search_texts(texts, K)
        torch.cuda.synchronize()
        launches = {
            "int8_scores": ops.int8_scores.launches,
            "int8_candidates_packed": ops.int8_candidates_packed.launches,
        }
    finally:
        ImageDatabase.scan_directory = original_scan
        ImageDatabase.generate_html_gallery = original_gallery

    check(len(scan_seconds) == 1, "scan did not run")
    rate = N_IMAGES / scan_seconds[0]
    print(f"[e2e] scan: {N_IMAGES} images in {scan_seconds[0]:.3f} s = {rate:.1f} images/s "
          f"(scan_directory, batch 64, SO400M bf16 random weights; {scan_wall:.1f} s with model "
          f"init)  ({gpu})", flush=True)
    print(f"[e2e] kernel launches in this phase: {launches}", flush=True)
    check(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")

    # What the database holds, and the brute-force reference over it.
    ids, vectors = engine.index.cache.load()
    check(len(ids) == N_IMAGES, f"{len(ids)} rows indexed, expected {N_IMAGES}")
    norms = np.linalg.norm(np.asarray(vectors), axis=1)
    check(np.abs(norms - 1).max() <= 1e-3, f"image embeddings off unit norm: {np.abs(norms - 1).max()}")
    paths = engine.store.fetch_paths_for_ids(ids)
    row_of = {paths[int(i)]: r for r, i in enumerate(ids)}
    rows_bf16 = torch.from_numpy(np.array(vectors, np.float32)).to(torch.bfloat16)

    # Tower-only times on device-resident inputs, beside the scan's rate.
    pixels = torch.randint(0, 256, (64, 224, 224, 3), dtype=torch.uint8, device="cuda")
    vision_ms = p50_ms(lambda: engine.model.get_image_features(pixels), 5)
    ids = torch.randint(0, engine.config.text.vocab_size, (4, 64), device="cuda")
    text_ms = p50_ms(lambda: engine.model.get_text_features(ids, torch.ones_like(ids)), 5)
    print(f"[e2e] towers alone: vision batch 64 p50 {vision_ms:.2f} ms = "
          f"{64e3 / vision_ms:.1f} images/s; text batch 4 p50 {text_ms:.2f} ms  ({gpu})", flush=True)

    check(len(captured) == 1 and captured[0], "the CLI search returned no results")
    # The CLI's single query takes the exact shortlist over every row, so its
    # results are the brute-force order (less duplicates, which it filters).
    q_cli = engine.embed_texts(["a red car"])[0]
    want_rows, want_scores = brute_force(rows_bf16, q_cli, K)
    cli_rows = [row_of[p] for p, _ in captured[0]]
    check(cli_rows == [r for r in want_rows if r in set(cli_rows)],
          "CLI search results are not the brute-force order")
    cli_scores = np.array([s for _, s in captured[0]])
    want_of = dict(zip(want_rows.tolist(), want_scores.tolist()))
    err = max(abs(s - want_of[r]) for r, s in zip(cli_rows, cli_scores))
    check(err <= 1e-5, f"CLI search scores off brute force by {err}")

    q_vecs = engine.embed_texts(texts)
    check(np.abs(np.linalg.norm(q_vecs, axis=1) - 1).max() <= 1e-3, "text embeddings off unit norm")
    check(engine.index._graphs is not None and len(engine.index._graphs) == 1,
          "search_texts did not run the fused program's CUDA graph")
    with plain_kernels(mods):
        # The batch ran as one captured graph of the kernels; the plain
        # route is the two-stage one, on the same batch-4 embeddings.
        batch_plain = engine.index.search_batch(q_vecs, K)
    for qi, (results, plain) in enumerate(zip(batch, batch_plain)):
        check(len(results) == K, f"search_texts query {qi}: {len(results)} results")
        got_rows = [row_of[p] for p, _ in results]
        got_scores = np.array([s for _, s in results])
        check(np.isfinite(got_scores).all(), "non-finite scores")
        order = np.lexsort((got_rows, -got_scores))
        check(list(order) == list(range(K)), f"query {qi} not ordered (score desc, row asc)")
        check([p for p, _ in results] == [p for p, _ in plain],
              f"search_texts query {qi}: results differ from the plain route")
        err = np.abs(got_scores - np.array([s for _, s in plain])).max()
        check(err <= 1e-6, f"search_texts query {qi}: scores off the plain route by {err}")
    print(f"[e2e] CLI search: {len(captured[0])} results, equal to a brute-force rescore of all "
          f"{N_IMAGES} rows; search_texts x{len(texts)} (the fused program, one CUDA graph): ordered, "
          f"equal to the two-stage plain route; embeddings unit-norm", flush=True)
    return launches, db, cache, engine


def read_rows(db, table, column, dtype):
    """(paths, (n, DIM) array) of one embedding table, read straight from
    the SQLite file in image_id order, the order of the index's rows:
    ``embeddings`` holds fp32 vectors, ``binary_embeddings`` one 0/1 byte
    per sign bit."""
    conn = sqlite3.connect(db)
    try:
        rows = conn.execute(
            f"SELECT i.file_path, t.{column} FROM {table} t JOIN images i ON i.id = t.image_id "
            "ORDER BY t.image_id"
        ).fetchall()
    finally:
        conn.close()
    width = DIM * np.dtype(dtype).itemsize
    check(rows and all(len(blob) == width for _, blob in rows),
          f"{db}: {table} is empty or holds blobs other than {width} bytes")
    data = np.frombuffer(b"".join(blob for _, blob in rows), dtype).reshape(len(rows), DIM)
    return [path for path, _ in rows], data.copy()


def check_against_reference(results, row_of, ref, k, tol, what):
    """Results (duplicates may be filtered out) against a reference score per
    row: every score within ``tol`` of the reference, every row within 1e-6
    of the reference's k-th score, ordered by the reference up to 1e-6 ties.
    Returns (max score error, positions where the ids differ from the
    reference's (score desc, row asc) order)."""
    rows = [row_of[p] for p, _ in results]
    check(len(rows) > 0, f"{what}: no results")
    top = np.lexsort((np.arange(len(ref)), -ref))[:k]
    kth = ref[top[-1]]
    check(all(ref[r] >= kth - 1e-6 for r in rows), f"{what}: a row outside the reference top {k}")
    check(all(ref[a] >= ref[b] - 1e-6 for a, b in zip(rows, rows[1:])), f"{what}: not in reference order")
    err = max(abs(s - ref[r]) for r, (_, s) in zip(rows, results))
    check(err <= tol, f"{what}: scores off the reference by {err}")
    want = [r for r in top if r in set(rows)]
    return err, [i for i, (a, b) in enumerate(zip(rows, want)) if a != b]


def phase_search_modes(mods, gpu, work, db, cache):
    """Phase 5: bf16, cascade and binary-only search through the CLI and the
    engine on phase 4's database; returns the launches of kernels 4-7."""
    _, tops, hops = mods
    from tpuclip_torch import cli
    from tpuclip_torch.engine import ImageDatabase

    captured = []
    original_gallery = ImageDatabase.generate_html_gallery

    def capture_gallery(self, results, *args, **kwargs):
        captured.append(list(results))
        return original_gallery(self, results, *args, **kwargs)

    counters = [tops.topk_tiles, hops.binary_scores, hops.binary_topk_q1, hops.binary_topk_batched]
    bin_db = str(work / "binary.db")
    common = ["--model-cache", cache, "--no-session"]
    ImageDatabase.generate_html_gallery = capture_gallery
    try:
        for kernel in counters:
            kernel.launches = 0
        cli.main(["search", "a red car", "-k", str(K), "--db", db, *common, "--precision", "bf16"])
        os.environ["TPUCLIP_SEARCH_PRECISION"] = "int8"
        cli.main(["search", "a red car", "-k", str(K), "--db", db, *common, "--mode", "cascade"])
        cascade_batch = ImageDatabase(db, cache, inference_batch_size=64).search_texts(TEXTS, K)
        os.environ["TPUCLIP_SEARCH_MODE"] = "exact"
        cli.main(["scan", str(work / "images"), "--db", bin_db, "--model-cache", cache,
                  "--inference-batch-size", "64", "--binary-only"])
        cli.main(["search", "a red car", "-k", str(K), "--db", bin_db, *common])
        bin_engine = ImageDatabase(bin_db, cache, inference_batch_size=64)
        binary_batch = bin_engine.search_texts(TEXTS, K)
        torch.cuda.synchronize()
        launches = {kernel.__name__: kernel.launches for kernel in counters}
    finally:
        ImageDatabase.generate_html_gallery = original_gallery
    print(f"[modes] kernel launches in this phase: {launches}", flush=True)
    check(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")
    check(len(captured) == 3, f"{len(captured)} CLI searches reached the gallery, expected 3")

    paths, vectors = read_rows(db, "embeddings", "vector", np.float32)
    row_of = {p: r for r, p in enumerate(paths)}
    q_cli = bin_engine.embed_texts(["a red car"])[0]

    # bf16: the bf16-rounded query's dots with the bf16 rows, exact in float64.
    rows_bf16 = torch.from_numpy(vectors).to(torch.bfloat16).double()
    ref = (rows_bf16 @ torch.from_numpy(q_cli).to(torch.bfloat16).double()).float().numpy()
    err, swaps = check_against_reference(captured[0], row_of, ref, K, 1e-5, "bf16 CLI search")
    print(f"[modes] search --precision bf16: {len(captured[0])} results, "
          f"{'ids identical to' if not swaps else f'near-tie swaps at {swaps} against'} a brute-force "
          f"bf16 scan of {N_IMAGES} rows, max score diff {err:.2e}", flush=True)

    # Cascade at depth 640 >= 512 rows: the fp32 brute force over the stored vectors.
    err, swaps = check_against_reference(captured[1], row_of, vectors @ q_cli, K, 1e-6,
                                         "cascade CLI search")
    errs = [err]
    for qi, (results, q) in enumerate(zip(cascade_batch, bin_engine.embed_texts(TEXTS))):
        check(len(results) == K, f"cascade search_texts query {qi}: {len(results)} results")
        err, more = check_against_reference(results, row_of, vectors @ q, K, 1e-6,
                                            f"cascade search_texts query {qi}")
        errs.append(err)
        swaps += more
    print(f"[modes] search --mode cascade and search_texts x{len(TEXTS)}: "
          f"{'ids identical to' if not swaps else f'near-tie swaps at {swaps} against'} an fp32 "
          f"brute force over the stored vectors, max score diff {max(errs):.2e}", flush=True)

    # Binary-only: the brute-force popcount order, and the plain route.
    bpaths, bits = read_rows(bin_db, "binary_embeddings", "embedding", np.uint8)
    matches = (bits & (q_cli >= 0).astype(np.uint8)).sum(1, dtype=np.int64)
    brow_of = {p: r for r, p in enumerate(bpaths)}
    cli_rows = [brow_of[p] for p, _ in captured[2]]
    order = np.lexsort((np.arange(len(matches)), -matches))[:K]
    check(cli_rows == [r for r in order if r in set(cli_rows)],
          "binary CLI search is not the brute-force popcount order")
    check([s for _, s in captured[2]] == [matches[r] / DIM for r in cli_rows],
          "binary CLI similarities are not matches / 1152")
    with plain_kernels(mods):
        # The CLI embedded its query alone; search_texts cached it from a
        # batch of 4, whose bf16 rounding (and so sign bits) may differ.
        single_plain = bin_engine.search_by_embedding(q_cli, K)
        batch_plain = bin_engine.search_texts(TEXTS, K)
    check(captured[2] == single_plain, "binary CLI search differs from the plain route")
    check(binary_batch == batch_plain, "binary search_texts differs from the plain route")
    check(all(len(r) == K for r in binary_batch), "binary search_texts returned too few results")
    print(f"[modes] scan --binary-only + search: {len(cli_rows)} results in the brute-force popcount "
          f"order, similarity = matches/{DIM}; search and search_texts x{len(TEXTS)} identical to "
          f"the plain route", flush=True)
    return launches


def masked(ref, rows_in):
    """``ref`` with -inf outside the rows ``rows_in``."""
    out = np.full(len(ref), -np.inf, ref.dtype)
    out[rows_in] = ref[rows_in]
    return out


def phase_filters(mods, gpu, work, db, cache):
    """Phase 6: folder-filtered search in every mode, and the int8 search
    without the rerank copy and without a rescore; returns kernel 3's
    launches in this phase."""
    ops, _, hops = mods
    from tpuclip_torch import cli
    from tpuclip_torch.engine import ImageDatabase

    folder = str(work / "images" / "set_1")
    bin_db = str(work / "binary.db")
    captured = []
    original_gallery = ImageDatabase.generate_html_gallery

    def capture_gallery(self, results, *args, **kwargs):
        captured.append(list(results))
        return original_gallery(self, results, *args, **kwargs)

    def search(database, *flags):
        cli.main(["search", "a red car", "-k", str(K), "--db", database, "--model-cache", cache,
                  "--no-session", *flags])

    counters = [ops.int8_scores, ops.int8_candidates, hops.binary_scores]
    ImageDatabase.generate_html_gallery = capture_gallery
    try:
        for kernel in counters:
            kernel.launches = 0
        search(db, "--folder", folder)
        search(db, "--folder", folder, "--precision", "bf16")
        os.environ["TPUCLIP_SEARCH_PRECISION"] = "int8"
        search(db, "--folder", folder, "--mode", "cascade")
        os.environ["TPUCLIP_SEARCH_MODE"] = "exact"
        search(bin_db, "--folder", folder)
        os.environ["TPUCLIP_DEVICE_RERANK"] = "0"
        search(db)
        host = ImageDatabase(db, cache, inference_batch_size=64)
        host_batch = host.search_texts(TEXTS, K)
        os.environ["TPUCLIP_SEARCH_RERANK"] = "0"
        search(db)
        torch.cuda.synchronize()
        launches = {kernel.__name__: kernel.launches for kernel in counters}
        with plain_kernels(mods):
            host_plain = host.search_texts(TEXTS, K)
            search(db)
            os.environ["TPUCLIP_SEARCH_RERANK"] = "1"
            search(db)
    finally:
        ImageDatabase.generate_html_gallery = original_gallery
        os.environ.pop("TPUCLIP_DEVICE_RERANK", None)
        os.environ.pop("TPUCLIP_SEARCH_RERANK", None)
    print(f"[filters] kernel launches in this phase: {launches}", flush=True)
    check(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")
    check(len(captured) == 8, f"{len(captured)} CLI searches reached the gallery, expected 8")
    int8_f, bf16_f, cascade_f, binary_f, host_cli, raw_cli, raw_plain, host_cli_plain = captured

    paths, vectors = read_rows(db, "embeddings", "vector", np.float32)
    row_of = {p: r for r, p in enumerate(paths)}
    in_set = [r for r, p in enumerate(paths) if p.startswith(folder + os.sep)]
    check(len(in_set) == N_IMAGES // 4, f"{len(in_set)} stored rows under set_1")
    q = host.embed_texts(["a red car"])[0]
    for results, what in ((int8_f, "int8"), (bf16_f, "bf16"), (cascade_f, "cascade"), (binary_f, "binary")):
        check(len(results) > 0 and all(p.startswith(folder + os.sep) for p, _ in results),
              f"--folder {what}: a result outside set_1, or none")

    # int8 (rows resident, so the masked route with the fp32 host rescore)
    # and the cascade (depth 640 >= 512 rows): the fp32 brute force.
    fp32 = masked(vectors @ q, in_set)
    report = []
    for results, what in ((int8_f, "int8"), (cascade_f, "cascade")):
        err, swaps = check_against_reference(results, row_of, fp32, K, 1e-6, f"--folder {what}")
        report.append(f"{what} {'ids identical' if not swaps else f'near-tie swaps at {swaps}'}, "
                      f"max diff {err:.2e}")
    bf16 = (torch.from_numpy(vectors).to(torch.bfloat16).double()
            @ torch.from_numpy(q).to(torch.bfloat16).double()).float().numpy()
    err, swaps = check_against_reference(bf16_f, row_of, masked(bf16, in_set), K, 1e-5, "--folder bf16")
    report.append(f"bf16 {'ids identical' if not swaps else f'near-tie swaps at {swaps}'}, max diff {err:.2e}")
    bpaths, bits = read_rows(bin_db, "binary_embeddings", "embedding", np.uint8)
    brow_of = {p: r for r, p in enumerate(bpaths)}
    matches = (bits & (q >= 0).astype(np.uint8)).sum(1, dtype=np.int64)
    matches[[r for r, p in enumerate(bpaths) if not p.startswith(folder + os.sep)]] = -1
    order = np.lexsort((np.arange(len(matches)), -matches))[:K]
    rows = [brow_of[p] for p, _ in binary_f]
    check(rows == [r for r in order if r in set(rows)], "--folder binary: not the brute-force popcount order")
    check([s for _, s in binary_f] == [matches[r] / DIM for r in rows], "--folder binary: similarities")
    report.append("binary in the brute-force popcount order")
    print(f"[filters] search --folder set_1 ({len(in_set)} of {N_IMAGES} rows), every result under "
          f"set_1, against brute forces over set_1: {'; '.join(report)}", flush=True)

    # The host route: kernel 3 (one query) or kernel 1 (the batch), then the
    # fp32 rescore from the host memmap; no rescore: the int8 scores.
    check(host_cli == host_cli_plain, "TPUCLIP_DEVICE_RERANK=0 CLI search differs from the plain route")
    check(host_batch == host_plain, "TPUCLIP_DEVICE_RERANK=0 search_texts differs from the plain route")
    check(raw_cli == raw_plain, "TPUCLIP_SEARCH_RERANK=0 CLI search differs from the plain route")
    check(len(host_cli) > 0 and len(raw_cli) > 0 and all(len(r) == K for r in host_batch),
          "the host route returned too few results")
    err = 0.0
    for results, qv in zip([host_cli, *host_batch], [q, *host.embed_texts_cached(TEXTS)]):
        err = max(err, max(abs(s - float(vectors[row_of[p]] @ qv)) for p, s in results))
    check(err <= 1e-6, f"the host route's scores are off the rows' fp32 dots by {err}")
    index = host.index
    check(index._rows_device is None, "the host route kept rows on the card")
    parts = {"int8": index._matrix.numel(), "scales": index._scales.numel() * 4,
             "binary words": index._bin_matrix.numel() * 4}
    check(index.resident_bytes() == sum(parts.values()), "resident bytes do not add up")
    print(f"[filters] TPUCLIP_DEVICE_RERANK=0: CLI search (kernel 3 at k_short {4 * K}) and "
          f"search_texts x{len(TEXTS)} (kernel 1) identical to the plain route, scores within "
          f"{err:.2e} of the rows' fp32 dots; TPUCLIP_SEARCH_RERANK=0: CLI search (kernel 3 at "
          f"k_short {K}) identical to the plain route; resident on the card: "
          f"{index.resident_bytes():,} bytes ({parts}, {len(paths)} rows padded to "
          f"{index._matrix.shape[0]:,}; no rerank rows)", flush=True)
    return launches["int8_candidates"]


def phase_patch_embed_library(pops, gpu, work, engine):
    """Phase 7: ``patch_embed_fused`` on 64 of the JPEGs with the vision
    tower's patch weights; returns kernel 8's launches in this phase."""
    from PIL import Image

    from tpuclip_torch.models.siglip import normalize_pixels
    from tpuclip_torch.ops.patch_embed import patch_embed_fused, patches_from_images_u8

    size = engine.image_size
    files = sorted((work / "images").rglob("*.jpg"))[:64]
    pixels = []
    for f in files:
        with Image.open(f) as img:
            pixels.append(np.asarray(img.convert("RGB").resize((size, size), Image.BICUBIC), np.uint8))
    pixels = np.stack(pixels)
    pixels = torch.from_numpy(pixels).cuda()
    tower = engine.model.vision
    weight, bias = tower.patch.weight.detach(), tower.patch.bias.detach()
    patch_embed_fused.launches = 0
    out = patch_embed_fused(patches_from_images_u8(pixels, tower.cfg.patch_size),
                            weight.t().to(torch.bfloat16), bias)
    torch.cuda.synchronize()
    launches = patch_embed_fused.launches
    print(f"[library] patch_embed_fused launches in this phase: {launches}", flush=True)
    check(launches > 0, "patch_embed_fused was not launched")
    # The tower normalises in bf16 (x differs by up to one bf16 step) and
    # rounds its output to bf16 by another path: loosely equal.
    with torch.no_grad():
        ref = tower.patch_embed(normalize_pixels(pixels, torch.bfloat16)).reshape(out.shape).float()
    err = (out.float() - ref).abs().max().item()
    top = ref.abs().max().item()
    check(out.shape == (64 * (size // tower.cfg.patch_size) ** 2, DIM) and bool(out.isfinite().all()),
          f"patch_embed_fused out {tuple(out.shape)} or non-finite")
    check(err <= 0.03 * top, f"patch_embed_fused off the tower's patch embedding by {err} (max {top})")
    print(f"[library] patch_embed_fused on {len(files)} JPEGs ({out.shape[0]:,} patch rows) with the "
          f"tower's own weights: max diff {err:.2e} from the tower's patch embedding (max |x| {top:.2f})",
          flush=True)
    return launches


def wall_p50_ms(fn, reps):
    """Median host-clock time of ``fn`` (which ends on the host) over
    ``reps`` calls, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


FUSED_PROGRAMS = [("text", b, 0) for b in (1, 4, 16, 64)] + [("image", 0, 1)] + [
    ("mixed", b, b) for b in (1, 4, 16)
]


def phase_fused_programs(mods, gpu, resident, engine):
    """Phase 8: the fused query programs at SO400M width over phase 3's
    1,000,000 resident rows, through the graph runner the index uses;
    returns the launches of kernels 1 and 2 in this phase."""
    ops = mods[0]
    from tpuclip_torch.ops.graphs import FusedGraphs

    rows, m, scales = resident
    model = engine.model
    texts = [f"{TEXTS[i % len(TEXTS)]}, photo {i}" for i in range(64)]
    rng = np.random.default_rng(8)
    size = engine.image_size
    tail = (m, scales, rows, K, N_ROWS)

    def program_of(kind, method):
        if kind == "text":
            return lambda i, a: ops.text_topk_fused(model, i, a, *tail, shortlist_method=method)
        if kind == "image":
            return lambda p: ops.image_topk_fused(model, p, *tail, shortlist_method=method)
        return lambda i, a, p: ops.mixed_topk_fused(model, i, a, p, *tail, shortlist_method=method)

    graphs = FusedGraphs("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    cases, expected = [], {"int8_scores": 0, "int8_candidates_packed": 0}
    ops.int8_scores.launches = 0
    ops.int8_candidates_packed.launches = 0
    for kind, nt, ni in FUSED_PROGRAMS:
        host = list(engine._tokenize_bucketed(texts[:nt])) if nt else []
        if ni:
            host.append(rng.integers(0, 256, (ni, size, size, 3), dtype=np.uint8))
        method = ops.resolve_shortlist_method(nt + ni)
        key = (kind, nt, ni, K, method)
        program = program_of(kind, method)
        before = graphs.capture_seconds
        out = graphs.run(key, program, host)  # the warm-up run, the capture, one replay
        # A run of the program launches its shortlist kernel once: here the
        # warm-up and the replay.
        expected["int8_scores" if method == "exact" else "int8_candidates_packed"] += 2
        cases.append((kind, nt, ni, key, program, host, out, graphs.capture_seconds - before))
    torch.cuda.synchronize()
    launches = {"int8_scores": ops.int8_scores.launches,
                "int8_candidates_packed": ops.int8_candidates_packed.launches}
    print(f"[fused] kernel launches in this phase: {launches} (expected {expected})", flush=True)
    check(launches == expected, f"the graphs' launches {launches} are not the programs' runs {expected}")
    pool_bytes = graphs.pool_bytes()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved() - reserved0

    report = []
    for kind, nt, ni, key, program, host, (s_g, r_g), capture_s in cases:
        name = f"{kind} {nt}+{ni}" if kind == "mixed" else f"{kind} {max(nt, ni)}"
        dev = [torch.from_numpy(x).cuda() for x in host]

        def eager():
            s, r = program(*[torch.from_numpy(x).cuda() for x in host])
            return s.cpu().numpy(), r.cpu().numpy()

        def two_stage():
            # Tower(s), the embeddings to the host, back up, then the search.
            parts = []
            if nt:
                parts.append(model.get_text_features(*[torch.from_numpy(x).cuda() for x in host[:2]]).cpu())
            if ni:
                parts.append(model.get_image_features(torch.from_numpy(host[-1]).cuda()).cpu())
            s, r = ops.topk_int8_rerank_fused_auto(torch.cat(parts).cuda(), m, scales, rows, K, n_valid=N_ROWS)
            return s.cpu().numpy(), r.cpu().numpy()

        s_e, r_e = eager()
        s_2, r_2 = two_stage()
        check(np.array_equal(r_g, r_e) and np.array_equal(r_g, r_2),
              f"fused {name}: graph, eager and two-stage ids differ")
        check(np.array_equal(s_g, s_e), f"fused {name}: graph scores are not bit-equal to eager")
        err = float(np.abs(s_g - s_2).max())
        check(err <= 1e-6 and np.isfinite(s_g).all() and s_g.shape == (nt + ni, K),
              f"fused {name}: scores off the two-stage route by {err}, or shape {s_g.shape}")
        graph = graphs._graphs[key].graph  # the replay alone, for its device time
        graph_ms = p50_ms(graph.replay, 20)
        eager_ms = p50_ms(lambda: program(*dev), 20)
        walls = {
            "graph": wall_p50_ms(lambda: graphs.run(key, program, host), 20),
            "eager": wall_p50_ms(eager, 20),
            "two_stage": wall_p50_ms(two_stage, 20),
        }
        report.append({"program": name, "method": key[-1], "graph_ms": graph_ms, "eager_ms": eager_ms,
                       "wall_ms": walls, "capture_s": capture_s, "max_err_two_stage": err})
        print(f"[fused] {name} ({key[-1]}): ids identical (graph, eager, two-stage), graph bit-equal "
              f"to eager, max diff {err:.2e} to two-stage; device p50 graph {graph_ms:.4f} ms vs eager "
              f"{eager_ms:.4f} ms; host-to-host p50 graph {walls['graph']:.4f} ms, eager "
              f"{walls['eager']:.4f} ms, two-stage {walls['two_stage']:.4f} ms; capture {capture_s:.3f} s  "
              f"({gpu})", flush=True)
    print(f"[fused] {len(graphs)} graphs captured in {graphs.capture_seconds:.3f} s; their shared pool "
          f"holds {pool_bytes:,} bytes (reserved memory grew by {reserved:,})  ({gpu})", flush=True)

    # The text tower alone, graph against eager.
    towers = FusedGraphs("cuda")
    tower_report = {}
    for b in (1, 4):
        host = list(engine._tokenize_bucketed(texts[:b]))
        dev = [torch.from_numpy(x).cuda() for x in host]
        (emb_g,) = towers.run(("tower", b), lambda i, a: (model.get_text_features(i, a),), host)
        check(np.array_equal(emb_g, model.get_text_features(*dev).cpu().numpy()),
              f"text tower batch {b}: graph differs from eager")
        graph_ms = p50_ms(towers._graphs[("tower", b)].graph.replay, 20)
        eager_ms = p50_ms(lambda: model.get_text_features(*dev), 20)
        tower_report[b] = {"graph_ms": graph_ms, "eager_ms": eager_ms}
        print(f"[fused] text tower alone, batch {b}: graph p50 {graph_ms:.4f} ms vs eager "
              f"{eager_ms:.4f} ms (bit-equal)  ({gpu})", flush=True)
    print("[phase8-json] " + json.dumps({"gpu": gpu, "programs": report, "text_tower": tower_report,
                                         "capture_s": graphs.capture_seconds, "pool_bytes": pool_bytes,
                                         "reserved_growth_bytes": reserved}), flush=True)
    return launches


def phase_serve(mods, gpu, work, db):
    """Phase 9: ``SearchServer`` end to end on phase 4's database, the
    rerank rows forced on; returns the launches of kernels 1 and 2 in this
    phase."""
    import base64
    import threading
    import urllib.request

    from tpuclip_torch.engine import ImageDatabase
    from tpuclip_torch.index.dedup import filter_duplicates
    from tpuclip_torch.io.decode import load_image_bytes
    from tpuclip_torch.pipelines.classify import classify_pil
    from tpuclip_torch.serve import SearchServer, warm_programs

    from tpuclip_torch import cli

    ops = mods[0]
    cache = str(work / "models")
    files = sorted((work / "images").rglob("*.jpg"))
    os.environ["TPUCLIP_DEVICE_RERANK"] = "1"
    try:
        # The CLI's single-image query takes the fused branch of the search
        # pipeline, whose errors read as "no results": it must return some.
        captured, fused_calls = [], []
        original_gallery, original_fused = ImageDatabase.generate_html_gallery, ImageDatabase._search_image_fused

        def fused_spy(self, *args):
            fused_calls.append(args)
            return original_fused(self, *args)

        ImageDatabase.generate_html_gallery = lambda self, results, *a, **kw: captured.append(list(results))
        ImageDatabase._search_image_fused = fused_spy
        try:
            cli.main(["search", str(files[7]), "--image", "-k", str(K), "--db", db, "--model-cache", cache,
                      "--no-session"])
        finally:
            ImageDatabase.generate_html_gallery = original_gallery
            ImageDatabase._search_image_fused = original_fused
        engine = ImageDatabase(db, cache, inference_batch_size=64)
    finally:
        os.environ.pop("TPUCLIP_DEVICE_RERANK", None)
    check(len(fused_calls) == 1 and len(captured) == 1 and captured[0],
          f"search --image: {len(fused_calls)} fused calls, results {captured}")
    want = filter_duplicates(engine.store, engine.index.search(engine._get_image_embedding(str(files[7])), K))
    check([p for p, _ in captured[0]] == [p for p, _ in want] and captured[0][0][0] == str(files[7])
          and max(abs(s - w) for (_, s), (_, w) in zip(captured[0], want)) <= 1e-6,
          "search --image differs from the two-stage route, or does not find its own image first")
    print(f"[serve] search --image (the fused single-image branch): {len(captured[0])} results, its own "
          f"image first, equal to the two-stage route", flush=True)
    b64 = [base64.b64encode(f.read_bytes()).decode() for f in files[:5]]
    labels = ["a red car", "a photo of noise", "a city at night"]
    statuses = []

    def call(path, payload=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}{path}", method="POST" if payload is not None else "GET",
            data=None if payload is None else json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=300) as r:
            statuses.append(r.status)
            return json.loads(r.read())

    ops.int8_scores.launches = 0
    ops.int8_candidates_packed.launches = 0
    srv = SearchServer(engine, host="127.0.0.1", port=0)
    t0 = time.perf_counter()
    warmed = warm_programs(engine)
    warm_s = time.perf_counter() - t0
    graphs = engine.index._graphs
    check(warmed == 24 and len(graphs) == 21,
          f"warm_programs made {warmed} calls and {len(graphs or ())} graphs, expected 24 and 21")
    pool_bytes = graphs.pool_bytes()
    print(f"[serve] warm_programs: {warmed} calls, {len(graphs)} graphs captured, in {warm_s:.3f} s "
          f"(capture {graphs.capture_seconds:.3f} s); shared pool {pool_bytes:,} bytes  ({gpu})", flush=True)
    thread = srv.start_background()
    health = call("/health")
    stats = call("/stats")
    text = call("/search", {"query": "a yellow taxi", "k": K})
    algebra = call("/search", {"query": "a red car + blue sky - night", "k": K})
    upload = call("/search", {"image_b64": b64[0], "k": K})
    batch = call("/search_batch", {"queries": TEXTS, "k": K})
    embed = call("/embed", {"texts": TEXTS[:2], "images_b64": b64[:1]})
    classify = call("/classify", {"image_b64": b64[0], "labels": labels})

    # The burst: the batcher's calls into the engine are recorded, for
    # references at the same batch shapes.
    engine_calls = []
    for name in ("_search_texts_fused", "_search_image_fused", "_search_mixed_fused", "embed_pils"):
        def spy(*args, _name=name, _fn=getattr(engine, name)):
            engine_calls.append((_name, args))
            return _fn(*args)
        setattr(engine, name, spy)
    try:
        mixed_before = srv.batcher.stats()["mixed_windows"]
        srv.batcher.window_s = 0.2  # the burst lands in one window
        burst_payloads = [{"query": q, "k": K} for q in TEXTS] + [{"image_b64": b, "k": K} for b in b64[1:5]]
        burst = [None] * len(burst_payloads)
        barrier = threading.Barrier(len(burst_payloads))

        def fire(i):
            barrier.wait(timeout=60)
            burst[i] = call("/search", burst_payloads[i])

        workers = [threading.Thread(target=fire, args=(i,)) for i in range(len(burst_payloads))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=300)
        srv.batcher.window_s = 0.002
        torch.cuda.synchronize()
        launches = {"int8_scores": ops.int8_scores.launches,
                    "int8_candidates_packed": ops.int8_candidates_packed.launches}
        mixed = srv.batcher.stats()["mixed_windows"] - mixed_before
    finally:
        for name in ("_search_texts_fused", "_search_image_fused", "_search_mixed_fused", "embed_pils"):
            engine.__dict__.pop(name, None)
    print(f"[serve] kernel launches in this phase: {launches}; mixed windows in the burst: {mixed}", flush=True)
    check(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")
    check(all(b is not None for b in burst), "a burst request got no answer")
    check(mixed >= 1, "the burst of texts and uploads formed no mixed window")
    check(health == {"status": "ok", "model": engine.model_name}, f"/health answered {health}")
    check(stats["images"] == N_IMAGES and stats["search_precision"] == "int8", f"/stats answered {stats}")

    # The two-stage references: the towers at the same batch shapes, the
    # embeddings on the host, then index.search_batch, dedup as the server.
    index = engine.index

    def pil(b):
        return load_image_bytes(base64.b64decode(b), "<bytes>")

    def image_embs(images):
        pixels = torch.from_numpy(engine._pixels_bucketed(images)).cuda()
        return engine.model.get_image_features(pixels)[: len(images)].cpu().numpy()

    by_text, by_image = {}, {}
    for name, args in engine_calls:
        if name == "_search_texts_fused":
            texts, k = args
            for t, res in zip(texts, index.search_batch(engine.embed_texts(texts), k)):
                by_text[t] = res
        elif name == "_search_mixed_fused":
            texts, images, k = args
            res = index.search_batch(np.concatenate([engine.embed_texts(texts), image_embs(images)]), k)
            by_text.update(zip(texts, res[: len(texts)]))
            by_image.update((np.asarray(im).tobytes(), r) for im, r in zip(images, res[len(texts):]))
        else:
            images = [args[0]] if name == "_search_image_fused" else list(args[0])
            res = index.search_batch(engine.embed_pils(images), K)
            by_image.update((np.asarray(im).tobytes(), r) for im, r in zip(images, res))

    def same(body, want, what, dedup=True):
        want = filter_duplicates(engine.store, want) if dedup and want else want
        got = [(r["path"], r["similarity"]) for r in body]
        check(len(got) > 0 and [p for p, _ in got] == [p for p, _ in want],
              f"{what}: paths differ from the two-stage route")
        err = max(abs(s - w) for (_, s), (_, w) in zip(got, want))
        check(err <= 1e-6, f"{what}: scores off the two-stage route by {err}")
        return err

    errs = [same(text["results"], index.search_batch(engine.embed_texts(["a yellow taxi"]), K)[0], "text /search")]
    want = engine.search("a red car", k=K, query2="blue sky", negative_query="night")
    errs.append(same(algebra["results"], want, "mini-language /search", dedup=False))
    want = index.search_batch(engine.embed_pils([pil(b64[0])]), K)[0]
    errs.append(same(upload["results"], want, "image_b64 /search"))
    for q, body, want in zip(TEXTS, batch["results"], index.search_batch(engine.embed_texts(TEXTS), K)):
        errs.append(same(body, want, f"/search_batch {q!r}", dedup=False))
    for payload, body in zip(burst_payloads, burst):
        if "query" in payload:
            errs.append(same(body["results"], by_text[payload["query"]], f"burst text {payload['query']!r}"))
        else:
            key = np.asarray(pil(payload["image_b64"])).tobytes()
            errs.append(same(body["results"], by_image[key], "burst upload"))
    emb_err = max(
        float(np.abs(np.asarray(embed["text_embeddings"]) - engine.embed_texts(TEXTS[:2])).max()),
        float(np.abs(np.asarray(embed["image_b64_embeddings"][0]) - engine._embed_pil(pil(b64[0]))).max()),
    )
    check(emb_err <= 1e-6, f"/embed off the engine's embeddings by {emb_err}")
    want = classify_pil(engine, pil(b64[0]), labels)
    check([r["label"] for r in classify["labels"]] == [l for l, _, _ in want]
          and all(abs(r["prob"] - p) <= 1e-6 for r, (_, p, _) in zip(classify["labels"], want)),
          f"/classify differs from classify_pil: {classify['labels']} vs {want}")

    latencies = []
    before = srv.batcher.stats()
    for i in range(50):
        t0 = time.perf_counter()
        body = call("/search", {"query": f"a photo number {i}", "k": K})
        latencies.append((time.perf_counter() - t0) * 1e3)
        check(len(body["results"]) > 0, "a sequential /search returned no results")
    p50, p99 = np.percentile(latencies, 50), np.percentile(latencies, 99)
    after = srv.batcher.stats()
    window_ms = (after["process_s"] - before["process_s"]) / (after["windows"] - before["windows"]) * 1e3
    # A re-upload (a write to the database, here forced) drops every graph:
    # the next request of each shape pays a warm-up run and a capture.
    index.refresh(force=True)
    reupload_ms = []
    for i in range(2):
        t0 = time.perf_counter()
        body = call("/search", {"query": f"after a re-upload {i}", "k": K})
        reupload_ms.append((time.perf_counter() - t0) * 1e3)
        check(len(body["results"]) > 0, "a /search after a re-upload returned no results")
    check(len(index._graphs) == 1, f"{len(index._graphs)} graphs after a re-upload and one program shape")
    print(f"[serve] after a re-upload: the first text /search {reupload_ms[0]:.3f} ms wall (capture "
          f"inside its window), the second {reupload_ms[1]:.3f} ms  ({gpu})", flush=True)
    check(all(code == 200 for code in statuses), f"statuses other than 200: {statuses}")
    srv.shutdown()
    thread.join(timeout=30)
    check(not thread.is_alive() and not srv.batcher._thread.is_alive(), "the server did not shut down")
    # Where a sequential request's time goes: the batcher's window (its
    # processing, lock wait included), and its steps alone on this thread.
    res = engine._search_texts_fused(["a photo number 0"], K)[0]

    def time_steps(out):
        out.update({
            "refresh": wall_p50_ms(engine.index.refresh, 20),
            "fingerprint": wall_p50_ms(engine.index._current_fingerprint, 20),
            "tokenize": wall_p50_ms(lambda: engine._tokenize_bucketed(["a photo number 0"]), 20),
            "fused_search": wall_p50_ms(lambda: engine._search_texts_fused(["a photo number 0"], K), 20),
            "map_results": wall_p50_ms(lambda: index._map_batch_results(
                np.zeros((1, K), np.float32), np.arange(K)[None], 1), 20),
            "dedup": wall_p50_ms(lambda: filter_duplicates(engine.store, res), 20),
        })
        return out

    steps = time_steps({})
    steps_thread = {}  # the same on a thread of its own, as the batcher runs them
    worker = threading.Thread(target=time_steps, args=(steps_thread,))
    worker.start()
    worker.join(timeout=300)
    for where, timed in (("this thread", steps), ("another thread", steps_thread)):
        print(f"[serve] a sequential /search: batcher window mean {window_ms:.3f} ms of the "
              f"{p50:.3f} ms wall; its steps alone on {where}, host p50 ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in timed.items()) + f"  ({gpu})", flush=True)
    print(f"[serve] /health, /stats, text /search, mini-language /search, image_b64 /search, 4-text "
          f"/search_batch, /embed, /classify and a burst of {len(burst_payloads)} (4 texts + 4 uploads): "
          f"{len(statuses)} responses, all 200, equal to the two-stage route (max score diff "
          f"{max(errs):.2e}); 50 sequential text /search: p50 {p50:.3f} ms, p99 {p99:.3f} ms wall "
          f"({gpu}); shut down cleanly", flush=True)
    print("[phase9-json] " + json.dumps({"gpu": gpu, "warm_calls": warmed, "warm_s": warm_s,
                                         "capture_s": graphs.capture_seconds, "pool_bytes": pool_bytes,
                                         "search_p50_ms": p50, "search_p99_ms": p99,
                                         "after_reupload_ms": reupload_ms, "window_mean_ms": window_ms, "steps_p50_ms": steps,
                                         "steps_other_thread_p50_ms": steps_thread,
                                         "mixed_windows": mixed, "launches": launches}), flush=True)
    return launches


def to_reference_layout(src, dst, chunk=64):
    """A copy of ``src`` as droon/CLIP-database leaves a database on disk:
    its fp32 vectors in sqlite-vec's vec0 shadow tables (chunks of ``chunk``
    rows with validity bitmaps and rowid blobs) with the ``image_embeddings``
    rowid map, and no ``embeddings`` rows, for ``migrate``."""
    import shutil
    import struct

    shutil.copyfile(src, dst)
    conn = sqlite3.connect(dst)
    try:
        rows = conn.execute("SELECT image_id, vector FROM embeddings ORDER BY image_id").fetchall()
        conn.executescript(
            "CREATE TABLE image_embeddings (rowid INTEGER PRIMARY KEY, image_id INTEGER);"
            "CREATE TABLE vec0_chunks (chunk_id INTEGER PRIMARY KEY AUTOINCREMENT, size INTEGER NOT NULL,"
            " validity BLOB NOT NULL, rowids BLOB NOT NULL);"
            "CREATE TABLE vec0_rowids (rowid INTEGER PRIMARY KEY AUTOINCREMENT, id, chunk_id INTEGER,"
            " chunk_offset INTEGER);"
            "CREATE TABLE vec0_vector_chunks00 (rowid INTEGER PRIMARY KEY AUTOINCREMENT, vectors BLOB NOT NULL);"
            "DELETE FROM embeddings;"
        )
        for c in range(-(-len(rows) // chunk)):
            validity, rowids = bytearray(chunk // 8), bytearray(chunk * 8)
            block = bytearray(chunk * DIM * 4)
            for off, (image_id, vector) in enumerate(rows[c * chunk:(c + 1) * chunk]):
                vec_rowid = c * chunk + off + 1
                validity[off >> 3] |= 1 << (off & 7)
                struct.pack_into("<q", rowids, off * 8, vec_rowid)
                block[off * DIM * 4:(off + 1) * DIM * 4] = vector
                conn.execute("INSERT INTO image_embeddings (rowid, image_id) VALUES (?, ?)", (vec_rowid, image_id))
                conn.execute("INSERT INTO vec0_rowids (rowid, id, chunk_id, chunk_offset) VALUES (?, NULL, ?, ?)",
                             (vec_rowid, c + 1, off))
            conn.execute("INSERT INTO vec0_chunks (chunk_id, size, validity, rowids) VALUES (?, ?, ?, ?)",
                         (c + 1, chunk, bytes(validity), bytes(rowids)))
            conn.execute("INSERT INTO vec0_vector_chunks00 (rowid, vectors) VALUES (?, ?)", (c + 1, bytes(block)))
        conn.commit()
    finally:
        conn.close()


def table_rows(db, sql):
    conn = sqlite3.connect(db)
    try:
        return conn.execute(sql).fetchall()
    finally:
        conn.close()


def run_cli(cli, *argv):
    """``cli.main(argv)``; a non-zero exit fails the phase with its command."""
    try:
        cli.main(list(argv))
    except SystemExit as e:
        check(e.code in (0, None), f"{' '.join(argv[:1])} exited with status {e.code}")


def phase_cli(gpu, work, db):
    """Phase 10: the interactive session, ``selftest --e2e-only`` and the
    database subcommands through ``tpuclip_torch.cli`` on phase 4's
    database; returns every counted kernel's launches in the session."""
    import builtins
    import shutil

    from tpuclip_torch import cli
    from tpuclip_torch import engine as engine_module
    from tpuclip_torch import selftest
    from tpuclip_torch.engine import ImageDatabase
    from tpuclip_torch.index.search import DeviceIndex
    from tpuclip_torch.ops._counters import COUNTED

    cache = str(work / "models")
    folder = str(work / "images" / "set_1")
    image = str(sorted((work / "images").rglob("*.jpg"))[7])
    query = "a red car"
    script = [f"k:{K}", query, f"folder:{folder}", query, "folder:clear", "a red car - blue sky - night - city",
              f"image:{image} + a bright photo", "duplicates:show", query, "quit"]
    n_searches = 5  # the lines that search, one query each
    pending = list(script)
    loads, uploads, engines, printed, calls = [], [], [], [], []
    saved = (engine_module.load_model, DeviceIndex.refresh, ImageDatabase.search, cli._make_engine,
             cli._print_results, cli.is_tty, builtins.input)

    def load_spy(*args, **kwargs):
        loads.append(args[0])
        return saved[0](*args, **kwargs)

    def refresh_spy(self, force=False):
        before = self._fingerprint
        saved[1](self, force)
        if self._fingerprint is not before:  # a new upload
            uploads.append(self._n_valid)

    def search_spy(self, q, **kwargs):
        t0 = time.perf_counter()
        out = saved[2](self, q, **kwargs)
        torch.cuda.synchronize()
        calls.append((q, kwargs, (time.perf_counter() - t0) * 1e3))
        return out

    def engine_spy(*args):
        engines.append(saved[3](*args))
        return engines[-1]

    def print_spy(results):
        printed.append(list(results))
        saved[4](results)

    engine_module.load_model, DeviceIndex.refresh, ImageDatabase.search = load_spy, refresh_spy, search_spy
    cli._make_engine, cli._print_results, cli.is_tty = engine_spy, print_spy, lambda: True
    builtins.input = lambda prompt="": pending.pop(0)
    try:
        for wrapper in COUNTED:
            wrapper.launches = 0
        run_cli(cli, "search", "--interactive", "--db", db, "--model-cache", cache)
        torch.cuda.synchronize()
        launches = {wrapper.__name__: wrapper.launches for wrapper in COUNTED}
    finally:
        (engine_module.load_model, DeviceIndex.refresh, ImageDatabase.search, cli._make_engine,
         cli._print_results, cli.is_tty, builtins.input) = saved
    print(f"[cli] session kernel launches: {launches}", flush=True)
    check(not pending, f"the session left lines unread: {pending}")
    check(len(loads) == 1 and len(engines) == 1, f"the towers loaded {len(loads)} times in the session")
    check(uploads == [N_IMAGES], f"the index uploaded {len(uploads)} times in the session: {uploads}")
    check(len(calls) == len(printed) == n_searches, f"{len(calls)} searches, {len(printed)} printed lists")
    check(launches["int8_scores"] == n_searches,
          f"kernel 1 launched {launches['int8_scores']} times for {n_searches} single-query lines")
    # Each printed list against the engine's single search with the same arguments.
    for (q, kwargs, _), got in zip(calls, printed):
        want = saved[2](engines[0], q, **kwargs)
        check(kwargs["k"] == K and got and [p for p, _ in got] == [p for p, _ in want],
              f"session search {q!r} {kwargs}: ids differ from the engine's single search")
        check([f"{s:.4f}" for _, s in got] == [f"{s:.4f}" for _, s in want],
              f"session search {q!r}: printed scores differ from the engine's single search")
    check(all(p.startswith(folder + "/") for p, _ in printed[1]), "the folder-filtered line left set_1")
    check(calls[2][1]["negative_queries"] == ["blue sky", "night", "city"] and calls[3][1]["is_image_path"]
          and calls[4][1]["show_duplicates"], "the session's lines did not reach the engine as parsed")
    first_ms, later = calls[0][2], [ms for _, _, ms in calls[1:]]

    # The same query from a fresh process: --no-session, and the session on
    # a non-tty stdin (runs the query and exits 0), wall from start to exit.
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    walls = {}
    for name, flags in (("--no-session", ["--no-session"]), ("session, non-tty stdin", [])):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpuclip_torch.cli", "search", query, "-k", str(K), "--db", db,
             "--model-cache", cache, *flags],
            env=env, stdin=subprocess.DEVNULL, capture_output=True, text=True, timeout=600,
        )
        walls[name] = time.perf_counter() - t0
        check(proc.returncode == 0 and "Results saved to" in proc.stdout,
              f"search {name} exited {proc.returncode}: {proc.stderr[-2000:]}")
    check("Interactive Search Session" in proc.stdout, "search without --no-session did not open the session")
    print(f"[cli] interactive session, {n_searches} single-query lines (k = {K}, SO400M random weights, "
          f"{N_IMAGES} rows): first query {first_ms:.3f} ms wall, later queries p50 "
          f"{statistics.median(later):.3f} ms (min {min(later):.3f}, max {max(later):.3f}); towers loaded "
          f"once, index uploaded once; every printed list id-identical to the engine's single search  ({gpu})",
          flush=True)
    print(f"[cli] a search process from start to exit: --no-session {walls['--no-session']:.3f} s, the "
          f"session on a non-tty stdin {walls['session, non-tty stdin']:.3f} s  ({gpu})", flush=True)

    # selftest --e2e-only on the card: the bundled tree at SO400M width.
    reports = []
    original_e2e = selftest.run_e2e_selftest
    selftest.run_e2e_selftest = lambda *a, **kw: reports.append(original_e2e(*a, **kw)) or reports[-1]
    try:
        t0 = time.perf_counter()
        run_cli(cli, "selftest", "--e2e-only", "--device", "cuda")
        selftest_s = time.perf_counter() - t0
    finally:
        selftest.run_e2e_selftest = original_e2e
    steps = [(s.name, s.status) for s in reports[0].steps]
    check(len(steps) == 7 and all(status == "PASS" for _, status in steps), f"selftest --e2e-only: {steps}")
    print(f"[cli] selftest --e2e-only --device cuda: {len(steps)} steps, all PASS, in {selftest_s:.3f} s  "
          f"({gpu})", flush=True)

    # The database subcommands on a copy of the database.
    out = work / "cli"
    out.mkdir()
    lib = str(out / "lib.db")
    shutil.copyfile(db, lib)
    to_reference_layout(lib, str(out / "ref.db"))
    t0 = time.perf_counter()
    run_cli(cli, "info", "--db", lib)
    run_cli(cli, "check", "--db", lib)
    run_cli(cli, "export", str(out / "out.npz"), "--db", lib, "--binary")
    run_cli(cli, "duplicates", "--db", lib)
    run_cli(cli, "prune", "--db", lib, "--dry-run")
    run_cli(cli, "migrate", "--db", str(out / "ref.db"), "--dry-run")
    run_cli(cli, "migrate", "--db", str(out / "ref.db"))
    run_cli(cli, "merge", str(out / "merged.db"), lib)
    run_cli(cli, "gc", "--dry-run", "--db", lib)
    commands_s = time.perf_counter() - t0
    paths, vectors = read_rows(lib, "embeddings", "vector", np.float32)
    bin_paths, bits = read_rows(lib, "binary_embeddings", "embedding", np.uint8)
    with np.load(out / "out.npz") as z:
        check(list(z["file_paths"]) == paths and np.array_equal(z["vectors"], vectors)
              and np.array_equal(z["binary"][np.argsort(z["binary_image_ids"])], bits),
              "export: the arrays differ from the SQLite rows")
    for name in ("merged.db", "ref.db"):
        got_paths, got = read_rows(str(out / name), "embeddings", "vector", np.float32)
        check(got_paths == paths and np.array_equal(got, vectors), f"{name}: the vectors differ from the copy's")
    images = "SELECT file_path, last_modified, file_hash FROM images ORDER BY file_path"
    check(table_rows(str(out / "merged.db"), images) == table_rows(lib, images)
          and read_rows(str(out / "merged.db"), "binary_embeddings", "embedding", np.uint8)[1].tolist()
          == bits.tolist() and bin_paths == paths, "merge: the merged database's rows differ")
    print(f"[cli] info, check, export (npz), duplicates, prune --dry-run, migrate --dry-run and migrate (a "
          f"reference vec0 copy), merge, gc --dry-run: all exit 0 in {commands_s:.3f} s; the export, the "
          f"migrated and the merged rows equal the database's {len(paths)} rows  ({gpu})", flush=True)
    print("[phase10-json] " + json.dumps({
        "gpu": gpu, "session_first_ms": first_ms, "session_later_ms": later,
        "session_later_p50_ms": statistics.median(later), "process_wall_s": walls,
        "selftest_e2e_s": selftest_s, "commands_s": commands_s, "launches": launches}), flush=True)
    return launches


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ab", action="append", default=[], metavar="LABEL:PATH",
                        help="another int8_scan.cu (kernels 2 and 3), binary_scan.cu (kernels 6 "
                             "and 7), topk_bf16.cu (kernel 4) or patch_embed.cu (kernel 8) to time "
                             "against this tree's, in turns")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from tpuclip_torch.ops import _build
    from tpuclip_torch.ops import hamming as hops
    from tpuclip_torch.ops import patch_embed as pops
    from tpuclip_torch.ops import topk as tops
    from tpuclip_torch.ops import topk_int8 as ops

    mods = (ops, tops, hops)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}; TF32 off", flush=True)
    print(f"[env] nvidia-smi: {gpu}", flush=True)

    t0 = time.perf_counter()
    b1_build = start_b1_rate_build()
    _build.build(force=True)
    print(f"[build] {', '.join(s.name for s in _build.SOURCES)} -> build/tpuclip_torch/ in "
          f"{time.perf_counter() - t0:.2f} s (one nvcc per source, in parallel: "
          f"{_build.last_build_seconds:.2f} s)", flush=True)
    _build.library()
    measure_b1_rate(b1_build, gpu)
    variants = build_variants(args.ab, hops) if args.ab else {}

    record, resident = phase_kernels(mods, gpu, variants)
    torch.cuda.empty_cache()
    phase_int8_4m(ops, gpu, variants.get("int8_scan.cu"))
    torch.cuda.empty_cache()
    record.update(phase_binary_kernels(hops, gpu, variants.get("binary_scan.cu")))
    torch.cuda.empty_cache()
    record["patch_embed_fused"] = phase_patch_embed(pops, gpu, variants.get("patch_embed.cu"))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches, db, cache, engine = phase_end_to_end(mods, gpu, Path(tmp))
        launches.update(phase_search_modes(mods, gpu, Path(tmp), db, cache))
        launches["int8_candidates"] = phase_filters(mods, gpu, Path(tmp), db, cache)
        launches["patch_embed_fused"] = phase_patch_embed_library(pops, gpu, Path(tmp), engine)
        # Kernels 1 and 2 also run in phases 8 and 9: each path's counts under its own key.
        fused = phase_fused_programs(mods, gpu, resident, engine)
        served = phase_serve(mods, gpu, Path(tmp), db)
        paths = {name: {"launches_fused": n, "launches_serve": served[name]} for name, n in fused.items()}
        session = phase_cli(gpu, Path(tmp), db)

    sources = {
        "int8_scores": ("tpuclip_torch/csrc/int8_scan.cu", "tpuclip/ops/topk_int8.py:340"),
        "int8_candidates_packed": ("tpuclip_torch/csrc/int8_scan.cu", "tpuclip/ops/topk_int8.py:189"),
        "int8_candidates": ("tpuclip_torch/csrc/int8_scan.cu", "tpuclip/ops/topk_int8.py:103"),
        "topk_tiles": ("tpuclip_torch/csrc/topk_bf16.cu", "tpuclip/ops/topk.py:41"),
        "binary_scores": ("tpuclip_torch/csrc/binary_scan.cu", "tpuclip/ops/hamming.py:354"),
        "binary_topk_q1": ("tpuclip_torch/csrc/binary_scan.cu", "tpuclip/ops/hamming.py:259"),
        "binary_topk_batched": ("tpuclip_torch/csrc/binary_scan.cu", "tpuclip/ops/hamming.py:132"),
        "binary_topk_batched_q16": ("tpuclip_torch/csrc/binary_scan.cu", "tpuclip/ops/hamming.py:132"),
        "patch_embed_fused": ("tpuclip_torch/csrc/patch_embed.cu", "tpuclip/ops/patch_embed.py:24"),
    }
    launches["binary_topk_batched_q16"] = launches["binary_topk_batched"]  # one kernel, two cases
    kernels = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], **paths.get(name, {}),
         "launches_session": session[name.removesuffix("_q16")], **record[name]}
        for name, (source, replaces) in sources.items()
    ]
    check("jax" not in sys.modules, "the port loaded jax")
    check(not [m for m in sys.modules if m == "tpuclip" or m.startswith("tpuclip.")],
          "the port loaded the JAX package (tpuclip)")
    print(gpu, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
