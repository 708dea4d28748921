"""Smoke run of the PyTorch port (tpuclip_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. environment: torch / CUDA versions, the card's name and power limit
   (nvidia-smi), TF32 off;
2. build: the CUDA kernels from tpuclip_torch/csrc, timed;
3. kernels against their plain PyTorch versions at the main path's size,
   1,000,000 unit-norm rows x 1152 (numpy seed 0, bf16 rows + int8 matrix
   on the card): int8_scores at Q = 1, 16 and int8_candidates_packed at
   Q = 16, 64 bit-equal; the fused int8 search at Q = 1, 16, k = 20 with
   the same ids and scores within 1e-6 as the route through the plain
   versions; CUDA-event p50 times of each kernel and its plain version;
4. end to end through the entry points: 512 seeded JPEGs, ``scan`` and
   ``search "a red car" -k 20 --no-session`` through tpuclip_torch.cli, and
   ``ImageDatabase.search_texts`` on 4 texts, with SigLIP2 SO400M-patch14-224
   at full width and random weights (TPUCLIP_INIT=random), bf16. Both kernel
   launch counters must rise in this phase; the CLI's results must match a
   brute-force rescore of the database, the batch's the plain route's, and
   embeddings must be unit-norm. jax must never have been imported.

The last two lines are the kernels' JSON record and then
``{"ok": true, "device": {...}}``.
"""

import json
import os
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


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


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
def plain_kernels(ops):
    """Route the fused search through the plain versions (on the same CUDA
    tensors) for the comparison; the kernels' counters do not move."""
    saved = ops.int8_scores, ops.int8_candidates_packed
    ops.int8_scores = ops._int8_scores_plain
    ops.int8_candidates_packed = ops._int8_candidates_packed_plain
    try:
        yield
    finally:
        ops.int8_scores, ops.int8_candidates_packed = saved


def phase_kernels(ops, gpu):
    """Phase 3: returns {kernel name: (max_abs_err, ms, plain_ms)}."""
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
    for q_count in (1, 16):
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
            record["int8_scores"] = (err, ms, plain)
    for q_count in (16, 64):
        qi, _ = ops.quantize_queries(queries[:q_count])
        args = (qi, m, scales, k_tile, N_ROWS, ops.PACKED_TILE_N)
        got = ops.int8_candidates_packed(*args)
        want = ops._int8_candidates_packed_plain(*args)
        check(torch.equal(got, want), f"int8_candidates_packed Q={q_count} keys differ")
        err = (got.long() - want.long()).abs().max().item()
        ms = p50_ms(lambda: ops.int8_candidates_packed(*args), 20)
        plain = p50_ms(lambda: ops._int8_candidates_packed_plain(*args), 5)
        print(f"[kernels] int8_candidates_packed Q={q_count} k_tile={k_tile}: keys bit-equal, "
              f"p50 {ms:.4f} ms vs plain {plain:.4f} ms  ({gpu})", flush=True)
        if q_count == 16:
            record["int8_candidates_packed"] = (err, ms, plain)
    for q_count in (1, 16):
        q = queries[:q_count]

        def fused():
            return ops.topk_int8_rerank_fused_auto(q, m, scales, rows, K, n_valid=N_ROWS)

        s, i = fused()
        with plain_kernels(ops):
            s_plain, i_plain = fused()
        check(torch.equal(i, i_plain), f"fused search Q={q_count}: ids differ from the plain route")
        err = (s - s_plain).abs().max().item()
        check(err <= 1e-6, f"fused search Q={q_count}: scores differ by {err}")
        ms = p50_ms(fused, 20)
        print(f"[kernels] fused int8 search Q={q_count} k={K}: ids identical to the plain route, "
              f"max score diff {err:.2e}, p50 {ms:.4f} ms  ({gpu})", flush=True)
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


def phase_end_to_end(ops, gpu, work):
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
        texts = ["a red car", "blue sky", "a dog on a beach", "city lights at night"]
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
    with plain_kernels(ops):
        batch_plain = engine.search_texts(texts, K)
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
          f"{N_IMAGES} rows; search_texts x{len(texts)}: ordered, equal to the plain route; "
          f"embeddings unit-norm", flush=True)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from tpuclip_torch.ops import _build
    from tpuclip_torch.ops import topk_int8 as ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}; TF32 off", flush=True)
    print(f"[env] nvidia-smi: {gpu}", flush=True)

    t0 = time.perf_counter()
    _build.build(force=True)
    print(f"[build] {_build.LIBRARY.relative_to(Path(__file__).resolve().parent)} from "
          f"tpuclip_torch/csrc/int8_scan.cu in {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.last_build_seconds:.2f} s)", flush=True)
    _build.library()

    record = phase_kernels(ops, gpu)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches = phase_end_to_end(ops, gpu, Path(tmp))

    replaces = {
        "int8_scores": "tpuclip/ops/topk_int8.py:340",
        "int8_candidates_packed": "tpuclip/ops/topk_int8.py:189",
    }
    kernels = [
        {"name": name, "route": "cuda", "source": "tpuclip_torch/csrc/int8_scan.cu",
         "replaces": replaces[name], "launches": launches[name], "max_abs_err": err,
         "ms": ms, "plain_ms": plain}
        for name, (err, ms, plain) in record.items()
    ]
    check("jax" not in sys.modules, "the port loaded jax")
    print(gpu, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
