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
   GEMM; and attention (kernel 9) at the vision encoder's launch in the
   benchmark's cells (B = 256, S = 256, 16 heads of 72), unmasked, with
   NaFlex's key masks and at the MAP head's Sq = 1, and at the 384 px
   cell's (B = 64, S = 729, ragged last query block and key tile),
   unmasked and at Sq = 1, within what rounding P once at bf16 allows of
   the plain version, timed beside the plain version and
   scaled_dot_product_attention, with the bound's share; then kernel 9's
   two designs alone (mma.sync and the Hopper one) in turns at every
   caller's shape (DINOv2's cell's launch among them: B = 32, S = 1,374,
   24 heads of 64), each within P's rounding, with the design the shape
   rule takes, and the Hopper design's registers and spills by
   ``nvcc -Xptxas -v`` (no spill and no serialized wgmma, or it fails);
   and the residual add + LayerNorm (kernel 10) at D
   1152 and 65,536, 46,656 and 4,096 rows, with and without the pending
   residual: x_out bit-equal to PyTorch's add, y within one bf16 step of
   F.layer_norm, the kernel alone, the wrapper, the plain version and
   torch.add + F.layer_norm timed after an L2 flush each, with the byte
   bound's share, and its registers and spills;
4. end to end through the entry points: 512 seeded JPEGs, ``scan`` and
   ``search "a red car" -k 20 --no-session`` through tpuclip_torch.cli, and
   ``ImageDatabase.search_texts`` on 4 texts, with SigLIP2 SO400M-patch14-224
   at full width and random weights (TPUCLIP_INIT=random), bf16. Both int8
   kernel launch counters and kernels 9's and 10's must rise in this phase; the CLI's results must
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
8. the fused query program (``query_topk_fused`` on texts, an image and
   mixed blocks) at SO400M width over phase 3's 1M resident rows,
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
   the SQLite rows read directly;
11. SigLIP2 NaFlex end to end, ``google/siglip2-so400m-patch16-naflex`` at
   full width with random weights, bf16: 192 seeded JPEGs in six aspect
   families (1:1, 3:1, 1:3, 8:1, 1:8 and a small 40 x 56, six patch
   grids), ``scan`` into a new database, ``search "a red car"`` and
   ``search --image`` through tpuclip_torch.cli against a brute force over
   the stored rows (the query image first); stored rows unit-norm and
   within 5e-3 (cosine >= 0.999) of the single-image path; the bf16 tower
   against the same weights in fp32 (cosine >= 0.999); the fused NaFlex
   programs (the lone image, mixed 1+1, 4+4, 16+16) over phase 3's 1M
   resident rows as CUDA graphs, bit-equal to eager and id-identical to
   the two-stage route (scores within 1e-6), with their device p50s,
   capture seconds and pool bytes; ``serve`` on the NaFlex database
   (``warm_programs`` 24 calls and 21 graphs, a text and an image_b64
   /search, /search_batch, /embed, /classify and a 4 + 4 burst with a
   mixed window, each equal to the two-stage route). Kernels 1 and 2 must
   count exactly the fused search's runs in the phase (each run outside a
   graph capture, and each graph replay), every other kernel 0;
12. IVF at full width: 1,000,000 x 1152 clustered unit rows (numpy seed 12,
   1,024 centres on the sphere, tests/test_ivf.py's mixture) resident in
   bf16 with their int8 matrix; ``build_ivf_device`` (K, C, overflow rows,
   bytes on the card, seconds), a rebuild after a 10% append reusing the
   centroids (timed); ``ivf_search`` at Q = 1, 4, 16, 64, k = 20: p50 beside
   the exact fused search on the same rows, every score within 1e-6 of the
   exact path's for its row, recall@20 against the exact search >= 0.90;
   nprobe = K id-identical to the exact search; the kernel route id- and
   score-identical to the route through ``_int8_scores_plain``; then on
   phase 4's database ``search --mode ivf`` (text and ``--image``) through
   tpuclip_torch.cli and ``serve`` under the mode (text /search, 4-text
   /search_batch, image /search), each equal to ``DeviceIndex.search_batch``
   under IVF. Kernel 1 must count exactly the probe's launches (one a
   query and one on the overflow block, every call), every other kernel 0;
13. training at full width: SigLIP2 SO400M-patch14-224, random weights, 64
   seeded JPEG/caption pairs, ``train --steps 5 --batch-size 16`` through
   tpuclip_torch.cli with ``--optimizer adamw`` and with ``auto`` (which
   must take Adafactor): the per-step p50 after step 1, images/s, peak
   allocated bytes and every loss, all finite; the model it writes loads
   through the port's loader and embeds unit rows; on one fixed batch the
   bf16 loss within 2e-2 relative of the fp32 loss with the same weights,
   and the loss and gradient norm with the layers checkpointed within 1e-3
   of those without. No kernel may run;
14. the mesh (``tpuclip_torch.parallel``), on tensors still resident from
   phases 3 and 12: (a) ``make_mesh(["cuda:0"] * 4)``, four shards of the
   card, over phase 3's 1M x 1152 rows (padded to 4 x 251,904): the int8
   rerank at Q = 1, 4, 16, 64, k = 20 (kernel 1, then 2, a shard), kernel
   3's route a shard at Q = 1 and 16, bf16 (kernel 4 a shard) with and
   without a folder mask, and over phase 3's 10M binary rows the binary
   search at Q = 1, 4, 16 (kernels 6, 7) and the cascade shortlist (kernel
   5), each with ids identical to the single-device search and a brute
   force (scores within 1e-6, bf16 1e-5, binary equal), timed beside the
   single-device search; (e, first half) an NCCL group of this one process
   through ``maybe_distributed_init`` (``TPUCLIP_MULTIHOST=1``): the merge
   through ``all_gather`` gives (a)'s results; (b) phase 12's IVF index
   (K = 2,000, its centroids) sharded by cluster with embedded bf16 rows:
   nprobe = K id-identical to the exact search, at the default nprobe the
   p50 at Q = 1 and 64, recall@20 >= 0.90, bytes on the card; (c)
   ``DeviceIndex(mesh=...)`` on phase 4's database (phase 5's binary-only
   one for that mode) in int8, bf16, binary-only, cascade and ivf (both
   indexes probing every bucket), through ``search_batch`` and the
   engine's ``search_texts``, equal to the unsharded index, and
   ``TPUCLIP_SHARDED_INDEX=1`` on one card building no mesh; (d) one
   data-parallel AdamW step at SO400M width (4 layers a tower), batch 16
   over ``make_mesh(["cuda:0"] * 2)``: loss, summed gradients and the
   parameters after the step within 2e-2 of the single-device step's, the
   replicas equal, step p50 and peak allocated bytes; (e, second half) two
   processes (this script with ``--mesh-worker``) over gloo, two shards of
   the card each: their int8 rerank ids identical to (a)'s. Kernels 1-7
   must launch on the mesh path, kernel 8 not;
15. the shortlist methods (``TPUCLIP_SHORTLIST``), run after phase 9 while
   phase 4's engine and phase 3's 1M rows are resident: (a) 256 seeded
   single queries through ``topk_int8_rerank_fused_auto`` under ``exact``,
   ``approx`` and ``verified`` and batches at Q = 4, 16, 64 under
   ``extract`` and ``approx``: L (15,744 bins at 1,001,472 rows), the
   proof's pass rate and the fallbacks; every shortlist that passes holds
   the exact int8 top-J of kernel 1's scores; verified's ids equal
   exact's but for rows ranked below J in the int8 scores (counted); every
   score within 1e-6 of its row's exact score; recall@20 of each method
   against ``exact``; (b) "a red car"'s text embedding copied into rows j
   and j + L (one bin): ``approx`` drops one, ``verified`` falls back once
   and equals ``exact`` (the rows are put back); (c) the fused text graph
   at buckets 1 and 16 under ``verified`` with one resident scores buffer,
   bit-equal to eager, the fallback over its device buffers equal to the
   exact program, the pool's bytes; (d) ``serve`` under ``verified`` on
   phase 4's database: 20 sequential text /search and ``/stats`` carrying
   ``verified_queries`` and ``shortlist_fallbacks``; (e) CUDA-event p50s
   of the fused search per method at Q = 1, 16, 64 and of the bucket-1
   text graph per method, the auto wrapper's host-to-host p50 at Q = 1
   under exact and verified, and a torch.profiler breakdown of both at
   Q = 1. Kernels 1 and 2 must launch in the phase;
16. tensor-parallel towers (``shard_params`` with a model axis above 1),
   after phase 14, the card named 2 and 4 times: (a) SO400M-patch14-224 at
   full width and depth (random weights, TPUCLIP_INIT=random), fp32 and
   bf16, over meshes (data 1, model 2), (2, 2) and (1, 4), one
   tensor-parallel replica a data row, each on its rows: image features of
   64 of phase 4's JPEGs and text features of the 4 masked texts, every
   row's cosine to one device's >= 0.99999 in fp32 and >= 0.999 in bf16,
   unit norm, the max abs difference printed; (b) so400m-patch16-naflex in
   bf16 at (1, 2) on 16 of phase 11's images over the six aspect families,
   cosine >= 0.999; (c) the (1, 2) fp32 text features through the index's
   default int8 search over phase 3's 1M rows (one query, kernel 1; the
   4-text batch, kernel 2): ids equal to one device's features' but for
   near-ties within 1e-5 (counted); (d) one data x model step at SO400M
   width (4 layers a tower), batch 16, fp32, over (2, 2), AdamW then
   Adafactor: the loss within 1e-4 relative of one device's step, each
   parameter shard within 1e-5 of its leaf's largest update (plus one
   fp32 rounding) of one device's step (the attention key biases, whose
   gradients are rounding noise, reported), the two rows equal, three
   steps' p50, peak allocated bytes and the parameter and optimizer bytes
   per rank; (e) the bf16 vision tower at batch 64: p50 and launches a
   call at (1, 2) and (1, 4) against one device. Every replica's blocks
   must be split (no one-device module on a tensor-parallel path).
   Neither jax nor the JAX package (tpuclip) may ever have been imported;
17. SigLIP2 at 384 px end to end, after phase 11: ``google/siglip2-so400m-
   patch14-384`` (27 x 27 = 729 tokens, random weights, bf16), 128 seeded
   JPEGs of four sizes resized to 384 x 384: ``scan --inference-batch-size
   64``, ``search "a red car"`` and ``search --image`` through
   tpuclip_torch.cli against a brute force over the stored rows (the query
   image first, rows unit-norm), ``search_image_pil`` through the index's
   image graph at 384 x 384 against the two-stage route; then, with the
   benchmark's seeded weights (``bench_port/weights.py``) in the model,
   ``query_topk_fused`` on images over phase 3's 1M rows captured as a graph at batch
   16 (captured once, replayed on a second batch) and 1, under
   ``verified`` with ``keep_scores`` so that its query rows come out:
   bit-equal to eager, and its rows and ``embed_images_uint8``'s (batch 64)
   within the ``embed.so400m-384.b64`` cell's ``max_row_dist`` of the plain
   fp32 reference (``bench_port/reference/siglip_ref.py``); the graphs'
   and eager device p50s and the tower's at batch 64;
18. DINOv2 with registers at 518 px, after phase 17: (a) kernel 11
   (``silu_mul``, SwiGLU's gate) at one ``embed.dinov2-g-518.b32`` call's
   43,968 rows of 2 x 4,096 within one bf16 step of its plain version, and
   kernel 10 at D 1536 with LayerScale's scale and without (x_out bit-equal
   to the plain version, y within one bf16 step), each kernel alone after
   an L2 flush (p50 of 20) against its byte bound, with the wrapper, the
   plain version and the nearest PyTorch calls; their registers and
   spills; (b) ``facebook/dinov2-with-registers-giant`` (37 x 37 patches
   + 1 class + 4 registers = 1,374 tokens, random weights, bf16), 64
   seeded JPEGs resized to 518 x 518: ``scan --inference-batch-size 32``
   and ``search --image`` through tpuclip_torch.cli against a brute force
   over the stored rows (the query image first, rows unit-norm, 1536-d), a
   text search refused with exit code 2, ``search_image_pil`` through the
   index's image graph against the two-stage route, 81 launches of kernel
   10 and 40 of kernel 11 a tower call; then, with the benchmark's seeded
   weights (``bench_port/drivers/embed_dinov2.py``) in the model,
   ``embed_images_uint8``'s rows (batch 32) within the cell's
   ``max_row_dist`` of the plain fp32 reference
   (``bench_port/reference/dinov2_ref.py``), and the tower's p50 at batch 32.

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
counts phase 10's session (0 where the session does not run it), its
``launches_naflex`` phase 11's NaFlex path, its ``launches_so400m_384``
phase 17's 384 px path (its graph and reference checks not counted), its ``launches_ivf`` phase
12's IVF path, its ``launches_train`` phase 13's training, its
``launches_mesh`` phase 14's mesh path (one run of each case: the
references and timing loops are not counted), its ``launches_shortlist``
phase 15's (its checks and timing loops not counted) and its
``launches_tp`` phase 16's (the one-device references not counted), its ``launches_dinov2``
phase 18's DINOv2 path (its checks and timing not counted), its ``launches_dinov3``
phase 19's DINOv3 path (the same); each count is zeroed just
before its path runs; kernels 9 (``attention``) and 10
(``add_layer_norm``, 55 launches a tower call) run wherever a tower
embeds with bf16 weights and no gradient, and training's phase 13 counts
none (its inference checks are not counted). ``library_ms`` is null
(no single PyTorch call computes any of these functions) but for kernel
9's, ``scaled_dot_product_attention``, a yardstick the port never calls,
and kernel 10's, ``torch.add`` + ``F.layer_norm``, the calls it replaced; and
``nearest_ms`` times the nearest route of PyTorch calls, where there is
one (kernel 1's: ``torch._int_mm`` at Q = 32, then the scales; kernel
11's: ``F.silu`` of the first half times the second). Kernels 4, 8, 10 and
11 also carry ``kernel_ms``, the kernel's own launch (``ms`` is the
wrapper's).
"""

import argparse
import ctypes
import functools
import json
import math
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
# Kernel 9's launch counters: every launch, and the Hopper design's share.
KERNEL_9 = ("attention", "attention_sm90")
# The kernels every bf16 tower call launches: kernel 9 and kernel 10 (the
# residual add and LayerNorm).
TOWER_KERNELS = KERNEL_9 + ("add_layer_norm",)
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


def main_rows(dev):
    """The main path's rows: 1,000,000 unit bf16 rows x 1152 and 64 unit
    fp32 queries on ``dev``, from numpy seed 0."""
    rng = np.random.default_rng(0)
    rows = torch.empty((N_ROWS, DIM), dtype=torch.bfloat16, device=dev)
    for s in range(0, N_ROWS, 65536):
        x = torch.from_numpy(rng.standard_normal((min(65536, N_ROWS - s), DIM), dtype=np.float32))
        x = x.to(dev)
        rows[s : s + len(x)] = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    queries = torch.from_numpy(rng.standard_normal((64, DIM), dtype=np.float32)).to(dev)
    return rows, queries / torch.linalg.vector_norm(queries, dim=1, keepdim=True)


def phase_kernels(mods, gpu, variants):
    """Phase 3, the dense kernels: returns ({kernel name: its record}, the
    resident (bf16 rows, int8 matrix, scales, queries), which phases 8,
    11 and 14 search)."""
    ops, tops, _ = mods
    dev = torch.device("cuda")
    rows, queries = main_rows(dev)
    n_pad = -(-N_ROWS // ops.INT8_TILE_N) * ops.INT8_TILE_N
    m, scales = ops.derive_int8_matrix(rows, n_pad)
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
            nearest = int_mm_route(qi, m, scales, got, gpu)
            record["int8_scores"] = entry(
                err, ms, plain, int8_scan_bytes(1, N_ROWS, n_pad * 4), 2 * N_ROWS * DIM, "int8",
                "torch._int_mm at Q=32 (the query and 31 zero rows) x scales", nearest)
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
    return record, (rows, m, scales, queries)


def int_mm_route(qi, m, scales, want, gpu):
    """Kernel 1's nearest PyTorch route at one query: ``torch._int_mm``
    (int8 x int8 -> int32 through cuBLAS, which takes at least 17 rows, so
    the query and 31 zero rows) then the f32 row scales. Returns its p50 ms,
    or None where this build of PyTorch refuses the call."""
    q32 = torch.zeros((32, qi.shape[1]), dtype=torch.int8, device=qi.device)
    q32[:1] = qi

    def route():
        return torch._int_mm(q32, m.T)[:1].float() * scales

    try:
        got = route()
    except RuntimeError as e:
        print(f"[kernels] torch._int_mm refused the Q=32 route: {e}", flush=True)
        return None
    n = want.shape[1]
    valid = torch.isfinite(want)
    check(torch.equal(got[valid], want[valid]), "torch._int_mm route differs from kernel 1 on the valid rows")
    ms = p50_ms(route, 20)
    print(f"[kernels] int8_scores' nearest route, torch._int_mm at Q=32 x scales over {n:,} rows: equal on "
          f"the valid rows, p50 {ms:.4f} ms  ({gpu})", flush=True)
    return ms


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


def attention_off_plain(aops, got, q, k, v, h, key_bias):
    """Whether kernel 9's ``got`` lies within what rounding P once at bf16
    allows of the plain version (each side within 2^-8 of w @ |v| of the
    exact sum, then rounded to bf16: |kernel - plain| <= 2^-7 (w @ |v| +
    |plain|), 2^-12 w @ |v| more for the logits' summation order), and the
    largest |kernel - plain| / (w @ |v|)."""
    b, sq, width = q.shape
    sk, hd = k.shape[1], width // h
    mask = None if key_bias is None else key_bias[:, None, None, :]
    plain = aops.attention_plain(q, k, v, h, mask).float()
    heads = lambda t, s: t.reshape(b, s, h, hd).transpose(1, 2).float()  # noqa: E731
    logits = torch.matmul(heads(q, sq), heads(k, sk).transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    if mask is not None:
        logits = logits + mask
    a = torch.matmul(torch.softmax(logits, dim=-1), heads(v, sk).abs()).transpose(1, 2).reshape(b, sq, width)
    del logits
    diff = (got.float() - plain).abs()
    return bool((diff <= 2.0**-7 * (a + plain.abs()) + 2.0**-12 * a).all()), float((diff / a).max())


def attention_case(aops, gpu, b, s, masked, seed):
    """Kernel 9 at B = ``b`` images of S = ``s`` tokens, 16 heads of 72:
    against the plain version within what rounding P once at bf16 allows
    (:func:`attention_off_plain`), unmasked, with NaFlex's key masks
    (243-256 real keys) where ``masked``, and at the MAP head's Sq = 1 (with
    the same masks where ``masked``); timed beside the plain version and
    ``scaled_dot_product_attention`` (a yardstick the port never calls).
    Prints one line and returns its record."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, hd = 16, 72
    width = h * hd
    q, k, v = ((torch.randn((b, s, width), generator=gen, device=dev) * 1.5).to(torch.bfloat16) for _ in range(3))
    bias = None
    if masked:
        real = torch.randint(243, s + 1, (b,), generator=gen, device=dev)
        bias = torch.where(torch.arange(s, device=dev)[None] < real[:, None], 0.0, torch.finfo(torch.float32).min)

    cases = [("unmasked", q, None)] + ([("masked", q, bias)] if masked else [])
    cases.append(("map_head", q[:, :1].contiguous(), bias))
    errs = {}
    for name, qq, key_bias in cases:
        ok, errs[name] = attention_off_plain(aops, aops.attention(qq, k, v, h, key_bias), qq, k, v, h, key_bias)
        check(ok, f"attention B={b} S={s} {name}: off the plain version by more than P's bf16 rounding allows")
    ms = p50_ms(lambda: aops.attention(q, k, v, h), 20)
    ms_masked = p50_ms(lambda: aops.attention(q, k, v, h, bias), 20) if masked else None
    ms_head = p50_ms(lambda: aops.attention(q[:, :1].contiguous(), k, v, h, bias), 20)
    plain = p50_ms(lambda: aops.attention_plain(q, k, v, h), 5)
    qh, kh, vh = (t.view(b, s, h, hd).transpose(1, 2) for t in (q, k, v))
    library = p50_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh).transpose(1, 2)
                     .reshape(b, s, width), 20)
    n_bytes = 4 * b * s * width * 2  # q, k, v read once, the output written once
    flops = 4 * b * h * s * s * hd
    record = entry(max(errs.values()), ms, plain, n_bytes, flops, "bf16")
    share = record["bound_ms"] / ms
    print(f"[kernels] attention B={b} S={s} H={h} hd={hd}: within P's bf16 rounding of the plain version "
          f"(max |kernel - plain| / (w @ |v|): {', '.join(f'{n} {e:.2e}' for n, e in errs.items())}); p50 "
          f"{ms:.4f} ms unmasked" + (f", {ms_masked:.4f} masked" if masked else "")
          + f", {ms_head:.4f} the MAP head's Sq = 1; bound {record['bound_ms']:.4f} ms "
          f"({record['bound_by']}), {100 * share:.1f}% of it; plain {plain:.4f} ms; "
          f"scaled_dot_product_attention {library:.4f} ms  ({gpu})", flush=True)
    return {**record, "library_ms": library, "ms_masked": ms_masked, "ms_map_head": ms_head, "bound_share": share}


def ptxas_report(gpu, source, pattern, label):
    """``nvcc -Xptxas -v`` on ``source`` (a file of ``csrc/``) with the
    build's flags: each instantiation whose mangled name matches ``pattern``
    (named by ``label`` formatted with its groups) with its registers and
    spills, and the compiler's wgmma remarks (C7510-C7520): under
    ``serialized`` those that say its products were serialized, under
    ``remarks`` all of them (C7519, a warpgroup.arrive the compiler adds,
    serializes nothing). Prints one line; returns {"kernels": ...,
    "remarks": ..., "serialized": ...}."""
    import re

    from tpuclip_torch.ops import _build

    src = _build.SOURCES[[x.name for x in _build.SOURCES].index(source)]
    with tempfile.TemporaryDirectory(prefix="ptxas_") as tmp:
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", f"{tmp}/lib.so", str(src)],
                              capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"nvcc -Xptxas -v on {src.name} failed:\n{proc.stderr[-3000:]}")
    kernels, name = {}, None
    for line in proc.stderr.splitlines():
        found = re.search(pattern, line)
        if "Compiling entry function" in line and found:
            name = label.format(*found.groups())
        elif name and "spill stores" in line:
            kernels[name] = {"spill_stores": int(re.search(r"(\d+) bytes spill stores", line).group(1)),
                             "spill_loads": int(re.search(r"(\d+) bytes spill loads", line).group(1))}
        elif name and "Used" in line and "registers" in line:
            kernels[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    found = [(f"{label.format(*m.groups())} {code}", "serialized" in line)
             for line in proc.stderr.splitlines() if "C75" in line
             for code in re.findall(r"\((C75[12]\d)\)", line) if 7510 <= int(code[1:]) <= 7520
             for m in [re.search(pattern, line)] if m]
    remarks = sorted({name for name, _ in found})
    serialized = sorted({name for name, ser in found if ser})
    print(f"[kernels] {source} -Xptxas -v: " + "; ".join(
        f"{k} {v['registers']} registers, {v['spill_stores']} / {v['spill_loads']} bytes spilled (stores / loads)"
        for k, v in kernels.items()) + f"; compiler remarks: {', '.join(remarks) or 'none'}; serialized: "
        f"{', '.join(serialized) or 'none'}  ({gpu})", flush=True)
    return {"kernels": kernels, "remarks": remarks, "serialized": serialized}


def attention_ptxas(gpu):
    """The Hopper design's registers and spills (:func:`ptxas_report`):
    fails on any spill and on any instantiation whose wgmma products the
    compiler serialized."""
    report = ptxas_report(gpu, "attention_sm90.cu", r"attention_sm90_kernelILi(\d+)ELb(\d)E", "<{}, bias={}>")
    check(report["kernels"], "attention_sm90.cu -Xptxas -v: no instantiation found")
    spilled = [k for k, v in report["kernels"].items() if v["spill_stores"] or v["spill_loads"]]
    check(not spilled, f"attention_sm90.cu: spills in {spilled}")
    check(not report["serialized"], f"attention_sm90.cu: wgmma serialized in {report['serialized']}")
    return report


# Kernel 9's launches in the benchmark's cells and the towers' other
# callers: (label, batch, Sq, Sk, heads, head width, NaFlex-style key
# masks). SO400M's 16 heads of 72, then the B/16 preset's 12 of 64 at 224
# px, DINOv2-g's 24 of 64 over 1,374 tokens (its cell's launch), g's 16 of
# 96 at 384 px (576 tokens) and a head width of 128.
ATTENTION_SHAPES = [
    ("384 layer", 64, 729, 729, 16, 72, False),
    ("224 layer", 256, 256, 256, 16, 72, False),
    ("NaFlex layer", 256, 256, 256, 16, 72, True),
    ("text layer", 64, 64, 64, 16, 72, True),
    ("S 128", 128, 128, 128, 16, 72, False),
    ("384 MAP head", 64, 1, 729, 16, 72, False),
    ("NaFlex MAP head", 256, 1, 256, 16, 72, True),
    ("B/16 layer, hd 64", 256, 196, 196, 12, 64, False),
    ("DINOv2 layer, hd 64", 32, 1374, 1374, 24, 64, False),
    ("g-384 layer, hd 96", 64, 576, 576, 16, 96, False),
    ("hd 128", 64, 512, 512, 8, 128, False),
]


def attention_designs(aops, gpu):
    """Kernel 9's two designs alone, each launched through its own C entry
    (mma.sync: ``tpuclip_attention``, Hopper: ``tpuclip_attention_sm90``)
    at every shape of :data:`ATTENTION_SHAPES`, both within
    P's bf16 rounding of the plain version, timed in turns (mma, Hopper,
    Hopper, mma; p50 of 20 launches each) beside the bound and
    ``scaled_dot_product_attention`` (a yardstick the port never calls).
    Prints a line a shape with the design ``takes_sm90`` gives; returns
    {label: record}."""
    from tpuclip_torch.ops._build import library

    dev = torch.device("cuda")
    lib = library()
    records = {}
    for label, b, sq, sk, h, hd, masked in ATTENTION_SHAPES:
        width = h * hd
        gen = torch.Generator(device=dev).manual_seed(b * 1000 + sq)
        q = (torch.randn((b, sq, width), generator=gen, device=dev) * 1.5).to(torch.bfloat16)
        k, v = ((torch.randn((b, sk, width), generator=gen, device=dev) * 1.5).to(torch.bfloat16) for _ in range(2))
        bias = None
        if masked:
            real = torch.randint(243 if sk == 256 else 1, sk + 1, (b,), generator=gen, device=dev)
            bias = torch.where(torch.arange(sk, device=dev)[None] < real[:, None], 0.0, torch.finfo(torch.float32).min)
        out = torch.empty((b, sq, width), dtype=torch.bfloat16, device=dev)
        args = aops._kernel_args(q, k, v, h, bias, out)
        runs = {"mma": lambda: lib.tpuclip_attention(*args), "sm90": lambda: lib.tpuclip_attention_sm90(*args)}
        for design, run in runs.items():
            check(run() == 0, f"attention {label}: the {design} design's launch failed")
            torch.cuda.synchronize()
            check(attention_off_plain(aops, out, q, k, v, h, bias)[0],
                  f"attention {label}: the {design} design is off the plain version by more than P's rounding")
        times = {}
        for design in ("mma", "sm90", "sm90", "mma"):
            times.setdefault(design, []).append(p50_ms(runs[design], 20))
        qh, kh, vh = (t.view(b, -1, h, hd).transpose(1, 2) for t in (q, k, v))
        mask = None if bias is None else bias[:, None, None, :]
        library_ms = p50_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask).transpose(1, 2).reshape(b, sq, width), 20)
        bound = entry(0.0, 1.0, None, (2 * b * sq + 2 * b * sk) * width * 2, 4 * b * h * sq * sk * hd, "bf16")
        best = {d: min(ts) for d, ts in times.items()}
        rule = "sm90" if aops.takes_sm90(sq, sk, hd) else "mma"
        records[label] = {"batch": b, "sq": sq, "sk": sk, "heads": h, "head_dim": hd, "masked": masked, "ms": times,
                          "library_ms": library_ms,
                          "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"], "rule": rule,
                          "bound_share": {d: bound["bound_ms"] / t for d, t in best.items()}}
        print(f"[kernels] attention designs, {label} (B={b} Sq={sq} Sk={sk} H={h} hd={hd}"
              f"{' masked' if masked else ''}): "
              f"mma.sync {' / '.join(f'{t:.4f}' for t in times['mma'])} ms "
              f"({100 * bound['bound_ms'] / best['mma']:.1f}% of the bound), Hopper "
              f"{' / '.join(f'{t:.4f}' for t in times['sm90'])} ms ({100 * bound['bound_ms'] / best['sm90']:.1f}%); "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}); scaled_dot_product_attention "
              f"{library_ms:.4f} ms; the rule takes {rule}  ({gpu})", flush=True)
        del q, k, v, out
        torch.cuda.empty_cache()
    return records


def phase_attention(aops, gpu):
    """Phase 3, kernel 9 (:func:`attention_case`) at the vision encoder's
    launch in the benchmark's cells: B = 256, S = 256 (patch14-224 and
    NaFlex, with its key masks), and B = 64, S = 729 (patch14-384: 6 query
    tiles of 128 rows and 6 key tiles of 128, each last one ragged), through
    the wrapper's shape rule; then its two designs alone in turns at every
    caller's shape (:func:`attention_designs`) and the Hopper design's
    registers (:func:`attention_ptxas`). The record is the S = 256 case's,
    with the S = 729 one under ``s729``, the designs' times under
    ``designs`` and the compiler's report under ``ptxas``."""
    record = attention_case(aops, gpu, 256, 256, True, 9)
    torch.cuda.empty_cache()
    record["s729"] = attention_case(aops, gpu, 64, 729, False, 10)
    torch.cuda.empty_cache()
    record["designs"] = attention_designs(aops, gpu)
    record["ptxas"] = attention_ptxas(gpu)
    return record


# Kernel 10's row counts at D 1152: a 224 or NaFlex call of 256 images, a
# 384 call of 64 images, a text call of 64 texts.
ADD_LN_ROWS = (65_536, 46_656, 4_096)
L2_FLUSH_BYTES = 256 << 20  # past the H100's 50 MB L2


def cold_p50_ms(fn, reps, flush):
    """Median CUDA-event time of ``fn`` over ``reps`` launches, each after
    ``flush`` (a write of more than the L2 cache holds) and outside its
    events: every launch finds its inputs in device memory, as a tower's
    pass finds most of them, and the host enqueues the launch while the
    flush runs."""
    fn()
    times = []
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_add_layernorm(lops, gpu):
    """Phase 3, kernel 10 at D 1152 and the cells' row counts
    (:data:`ADD_LN_ROWS`), with the pending residual and without (the first
    LN1): x_out bit-equal to PyTorch's bf16 add, y within one bf16 step of
    ``F.layer_norm`` of it (plus 1e-5 near zero, for the statistics' other
    summation order); the kernel alone (its C entry, outputs allocated
    outside the timed launch), the wrapper, the plain version and
    ``torch.add`` + ``F.layer_norm`` (the nearest PyTorch calls, which the
    port no longer makes), each launch after an L2 flush, p50 of 20; then
    the compiler's registers and spills. The record is the 65,536-row fused
    case's, every case under ``cases``."""
    from tpuclip_torch.ops._build import library

    dev = torch.device("cuda")
    lib = library()
    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    stream = torch.cuda.current_stream().cuda_stream
    d, eps = DIM, 1e-6
    cases = {}
    for rows in ADD_LN_ROWS:
        gen = torch.Generator(device=dev).manual_seed(rows)
        x = (torch.randn((rows, d), generator=gen, device=dev) * 3
             + torch.randn((rows, 1), generator=gen, device=dev)).to(torch.bfloat16)
        delta = torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(torch.bfloat16)
        b = (0.1 * torch.randn(d, generator=gen, device=dev)).to(torch.bfloat16)
        x_out, y = torch.empty_like(x), torch.empty_like(x)
        for with_delta in (True, False):
            dx = delta if with_delta else None
            got_x, got_y = lops.add_layer_norm(x, dx, w, b, eps)
            want_x, want_y = lops.add_layer_norm_plain(x, dx, w, b, eps)
            check(torch.equal(got_x, want_x), f"add_layer_norm rows={rows}: x_out is not PyTorch's bf16 add")
            err = (got_y.float() - want_y.float()).abs()
            _, exp = torch.frexp(want_y.float())
            step = torch.ldexp(torch.ones_like(err), exp - 8)
            check(bool((err <= step + 1e-5).all()),
                  f"add_layer_norm rows={rows} delta={with_delta}: y more than one bf16 step off "
                  f"(max diff {err.max().item():.2e})")
            args = (x.data_ptr(), dx.data_ptr() if with_delta else 0, 0, w.data_ptr(), b.data_ptr(),
                    x_out.data_ptr() if with_delta else 0, y.data_ptr(), rows, d, eps, stream)

            def kernel(args=args):
                check(lib.tpuclip_add_layernorm(*args) == 0, "add_layernorm launch failed")

            kernel_ms = cold_p50_ms(kernel, 20, flush)
            ms = cold_p50_ms(lambda: lops.add_layer_norm(x, dx, w, b, eps), 20, flush)
            plain = cold_p50_ms(lambda: lops.add_layer_norm_plain(x, dx, w, b, eps), 20, flush)
            library_ms = cold_p50_ms(lambda: torch.nn.functional.layer_norm(
                torch.add(x, dx) if with_delta else x, (d,), w, b, eps), 20, flush)
            n_bytes = rows * d * 2 * (4 if with_delta else 2) + 2 * d * 2
            record = {**entry(err.max().item(), ms, plain, n_bytes, 0, "bf16"),
                      "kernel_ms": kernel_ms, "library_ms": library_ms,
                      "bit_equal_share": float((err == 0).float().mean())}
            record["bound_share"] = record["bound_ms"] / kernel_ms
            cases[f"{rows}{'' if with_delta else '_ln_only'}"] = record
            print(f"[kernels] add_layer_norm rows={rows:,} D={d} {'x + delta' if with_delta else 'no delta'}: "
                  f"x_out bit-equal to the add, y within one bf16 step of F.layer_norm (max diff "
                  f"{record['max_abs_err']:.2e}, {100 * record['bit_equal_share']:.4f}% bit-equal); "
                  f"kernel alone p50 {kernel_ms:.4f} ms, {100 * record['bound_share']:.1f}% of the byte bound "
                  f"{record['bound_ms']:.4f} ms ({n_bytes / kernel_ms / 1e6:.0f} GB/s); wrapper {ms:.4f} ms; plain "
                  f"{plain:.4f} ms; torch.add + F.layer_norm {library_ms:.4f} ms (L2 flushed before each launch)  "
                  f"({gpu})", flush=True)
        del x, delta, x_out, y
        torch.cuda.empty_cache()
    del scratch
    record = dict(cases[str(ADD_LN_ROWS[0])])
    record["cases"] = cases
    record["ptxas"] = ptxas_report(gpu, "add_layernorm.cu", r"add_layernorm_kernelILi(\d+)ELb(\d)ELb(\d)E",
                                   "<{} vectors a lane, delta={}, scale={}>")
    return record


def phase_binary_kernels(hops, gpu, variants):
    """Phase 3, the binary kernels on 10M packed rows of random bits (dense
    ties): returns ({kernel name: its record}, (the padded words, the 64
    queries)), which phase 14 searches; kernel 7 has two records, at Q = 4,
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
    return record, (words, queries)


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


def check_brute_force(results, q, rows_bf16, row_of, what):
    """CLI results (duplicates filtered) in the brute-force order over the
    stored rows, scores within 1e-5."""
    want_rows, want_scores = brute_force(rows_bf16, q, K)
    got_rows = [row_of[p] for p, _ in results]
    check(len(got_rows) > 0 and got_rows == [r for r in want_rows if r in set(got_rows)],
          f"{what}: results are not the brute-force order")
    want_of = dict(zip(want_rows.tolist(), want_scores.tolist()))
    err = max(abs(s - want_of[r]) for r, (_, s) in zip(got_rows, results))
    check(err <= 1e-5, f"{what}: scores off brute force by {err}")


def phase_end_to_end(mods, gpu, work):
    """Phase 4: returns (launches of kernels 1, 2, 9 (its Hopper design
    also under ``attention_sm90``), 10, 11 and 12 (none: SigLIP has no
    SwiGLU gate and no rotary positions), database, model cache, engine)."""
    ops = mods[0]
    from tpuclip_torch import cli
    from tpuclip_torch.engine import ImageDatabase
    from tpuclip_torch.ops.attention import attention, attention_sm90
    from tpuclip_torch.ops.layernorm import add_layer_norm
    from tpuclip_torch.ops.rope import rope
    from tpuclip_torch.ops.swiglu import silu_mul

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
        attention.launches = 0
        attention_sm90.launches = 0
        add_layer_norm.launches = 0
        silu_mul.launches = 0
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
            "attention": attention.launches,
            "attention_sm90": attention_sm90.launches,
            "add_layer_norm": add_layer_norm.launches,
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
    launches["silu_mul"], launches["rope"] = silu_mul.launches, rope.launches
    check(launches["silu_mul"] == launches["rope"] == 0, f"kernel 11 or 12 ran on the SigLIP path: {launches}")

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
    check_brute_force(captured[0], engine.embed_texts(["a red car"])[0], rows_bf16, row_of, "CLI search")

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

    rows, m, scales = resident[:3]
    model = engine.model
    texts = [f"{TEXTS[i % len(TEXTS)]}, photo {i}" for i in range(64)]
    rng = np.random.default_rng(8)
    size = engine.image_size
    tail = (m, scales, rows, K, N_ROWS)

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
        program = fused_program(ops, model, nt, tail, method)
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


def http_call(srv, statuses, path, payload=None):
    """GET ``path`` of ``srv`` (POST ``payload`` as JSON); the status goes
    to ``statuses``, the parsed body is returned."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", method="POST" if payload is not None else "GET",
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=300) as r:
        statuses.append(r.status)
        return json.loads(r.read())


def serve_burst(srv, engine, call, payloads):
    """``payloads`` to /search at once behind a barrier, in one batcher
    window: returns (the answers, the mixed windows among them, the
    batcher's calls into the engine, for references at the same batch
    shapes)."""
    import threading

    engine_calls = []
    names = ("_search_texts_fused", "_search_image_fused", "_search_mixed_fused", "embed_pils")
    for name in names:
        def spy(*args, _name=name, _fn=getattr(engine, name)):
            engine_calls.append((_name, args))
            return _fn(*args)
        setattr(engine, name, spy)
    answers = [None] * len(payloads)
    barrier = threading.Barrier(len(payloads))

    def fire(i):
        barrier.wait(timeout=60)
        answers[i] = call("/search", payloads[i])

    try:
        mixed_before = srv.batcher.stats()["mixed_windows"]
        srv.batcher.window_s = 0.2  # the burst lands in one window
        workers = [threading.Thread(target=fire, args=(i,)) for i in range(len(payloads))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=300)
        srv.batcher.window_s = 0.002
        mixed = srv.batcher.stats()["mixed_windows"] - mixed_before
    finally:
        for name in names:
            engine.__dict__.pop(name, None)
    check(all(a is not None for a in answers), "a burst request got no answer")
    check(mixed >= 1, "the burst of texts and uploads formed no mixed window")
    return answers, mixed, engine_calls


def bucketed_image_embs(engine, images):
    """The vision tower on ``images`` padded to their ladder bucket, as a
    fused mixed program runs it; the real rows, on the host."""
    from tpuclip_torch.utils.bucketing import batch_bucket

    inputs = [torch.from_numpy(x).cuda() for x in engine._image_inputs(images, batch_bucket(len(images)))]
    return engine.model.image_features(*inputs)[: len(images)].cpu().numpy()


def same_served(engine, body, want, what, dedup=True):
    """A served result list against the two-stage route's (deduplicated as
    the server does): the same paths, scores within 1e-6; returns the
    largest score difference."""
    from tpuclip_torch.index.dedup import filter_duplicates

    want = filter_duplicates(engine.store, want) if dedup and want else want
    got = [(r["path"], r["similarity"]) for r in body]
    check(len(got) > 0 and [p for p, _ in got] == [p for p, _ in want],
          f"{what}: paths differ from the two-stage route")
    err = max(abs(s - w) for (_, s), (_, w) in zip(got, want))
    check(err <= 1e-6, f"{what}: scores off the two-stage route by {err}")
    return err


def check_served(engine, b64, upload, batch, embed, labels, classify, burst_payloads, burst, engine_calls):
    """The answers of an upload /search (``b64``), a /search_batch of
    TEXTS, /embed (TEXTS[:2] and ``b64``), /classify (``b64``, ``labels``)
    and a burst against the two-stage route: the towers at the same batch
    shapes, the embeddings on the host, then ``index.search_batch``;
    returns the score differences."""
    import base64

    from tpuclip_torch.io.decode import load_image_bytes
    from tpuclip_torch.pipelines.classify import classify_pil

    index = engine.index
    same = functools.partial(same_served, engine)

    def pil(b):
        return load_image_bytes(base64.b64decode(b), "<bytes>")

    by_text, by_image = {}, {}
    for name, args in engine_calls:
        if name == "_search_texts_fused":
            texts, k = args
            for t, res in zip(texts, index.search_batch(engine.embed_texts(texts), k)):
                by_text[t] = res
        elif name == "_search_mixed_fused":
            texts, images, k = args
            embs = np.concatenate([engine.embed_texts(texts), bucketed_image_embs(engine, images)])
            res = index.search_batch(embs, k)
            by_text.update(zip(texts, res[: len(texts)]))
            by_image.update((np.asarray(im).tobytes(), r) for im, r in zip(images, res[len(texts):]))
        else:
            images = [args[0]] if name == "_search_image_fused" else list(args[0])
            res = index.search_batch(engine.embed_pils(images), K)
            by_image.update((np.asarray(im).tobytes(), r) for im, r in zip(images, res))

    errs = [same(upload["results"], index.search_batch(engine.embed_pils([pil(b64)]), K)[0], "image_b64 /search")]
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
        float(np.abs(np.asarray(embed["image_b64_embeddings"][0]) - engine._embed_pil(pil(b64))).max()),
    )
    check(emb_err <= 1e-6, f"/embed off the engine's embeddings by {emb_err}")
    want = classify_pil(engine, pil(b64), labels)
    check([r["label"] for r in classify["labels"]] == [l for l, _, _ in want]
          and all(abs(r["prob"] - p) <= 1e-6 for r, (_, p, _) in zip(classify["labels"], want)),
          f"/classify differs from classify_pil: {classify['labels']} vs {want}")
    return errs


def phase_serve(mods, gpu, work, db):
    """Phase 9: ``SearchServer`` end to end on phase 4's database, the
    rerank rows forced on; returns the launches of kernels 1 and 2 in this
    phase."""
    import base64
    import threading
    import urllib.request

    from tpuclip_torch.engine import ImageDatabase
    from tpuclip_torch.index.dedup import filter_duplicates
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

    ops.int8_scores.launches = 0
    ops.int8_candidates_packed.launches = 0
    srv = SearchServer(engine, host="127.0.0.1", port=0)
    call = functools.partial(http_call, srv, statuses)
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

    burst_payloads = [{"query": q, "k": K} for q in TEXTS] + [{"image_b64": b, "k": K} for b in b64[1:5]]
    burst, mixed, engine_calls = serve_burst(srv, engine, call, burst_payloads)
    torch.cuda.synchronize()
    launches = {"int8_scores": ops.int8_scores.launches,
                "int8_candidates_packed": ops.int8_candidates_packed.launches}
    print(f"[serve] kernel launches in this phase: {launches}; mixed windows in the burst: {mixed}", flush=True)
    check(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")
    check(health == {"status": "ok", "model": engine.model_name}, f"/health answered {health}")
    check(stats["images"] == N_IMAGES and stats["search_precision"] == "int8", f"/stats answered {stats}")

    index = engine.index
    same = functools.partial(same_served, engine)
    errs = [same(text["results"], index.search_batch(engine.embed_texts(["a yellow taxi"]), K)[0], "text /search")]
    want = engine.search("a red car", k=K, query2="blue sky", negative_query="night")
    errs.append(same(algebra["results"], want, "mini-language /search", dedup=False))
    errs += check_served(engine, b64[0], upload, batch, embed, labels, classify, burst_payloads, burst, engine_calls)

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

NAFLEX_MODEL = "google/siglip2-so400m-patch16-naflex"
N_NAFLEX = 192
# (height, width) of the six aspect families: square, landscape 3:1,
# portrait 1:3, landscape 8:1, portrait 1:8, and a small 40 x 56.
NAFLEX_SIZES = [(256, 256), (128, 384), (384, 128), (64, 512), (512, 64), (40, 56)]
NAFLEX_PROGRAMS = [("naflex_image", 0, 1)] + [("naflex_mixed", b, b) for b in (1, 4, 16)]


def write_naflex_jpegs(root):
    """N_NAFLEX seeded JPEGs, the aspect families in turn, one folder each."""
    from PIL import Image

    rng = np.random.default_rng(11)
    for i in range(N_NAFLEX):
        h, w = NAFLEX_SIZES[i % len(NAFLEX_SIZES)]
        folder = root / f"{h}x{w}"
        folder.mkdir(parents=True, exist_ok=True)
        arr = np.clip(rng.integers(0, 256, (1, 1, 3)) + rng.integers(-40, 40, (h, w, 3)), 0, 255)
        Image.fromarray(arr.astype(np.uint8)).save(folder / f"img_{i:04d}.jpg", quality=90)


@contextmanager
def search_runs(ops):
    """Counts, while open, the runs of the fused int8 search by the kernel
    each runs once (the ``exact`` shortlist kernel 1, ``extract`` kernel 2;
    k <= 128 here): every call of ``topk_int8_rerank_fused`` outside a CUDA
    graph capture, and every replay of a graph by ``FusedGraphs.run``, under
    its key's method."""
    from tpuclip_torch.ops.graphs import FusedGraphs

    kernel_of = {"exact": "int8_scores", "extract": "int8_candidates_packed"}
    runs = dict.fromkeys(kernel_of.values(), 0)
    search, run = ops.topk_int8_rerank_fused, FusedGraphs.run

    def search_spy(*args, **kwargs):
        if not torch.cuda.is_current_stream_capturing():
            runs[kernel_of[kwargs.get("shortlist_method", "extract")]] += 1
        return search(*args, **kwargs)

    def run_spy(self, key, program, host_inputs, *tail):
        out = run(self, key, program, host_inputs, *tail)
        runs[kernel_of[key[-1]]] += 1
        return out

    ops.topk_int8_rerank_fused, FusedGraphs.run = search_spy, run_spy
    try:
        yield runs
    finally:
        ops.topk_int8_rerank_fused, FusedGraphs.run = search, run


def phase_naflex(mods, gpu, work, resident):
    """Phase 11: SigLIP2 so400m-patch16-naflex end to end; returns every
    counted kernel's launches in the phase."""
    import base64

    from tpuclip_torch import cli
    from tpuclip_torch.engine import ImageDatabase
    from tpuclip_torch.io.decode import load_image
    from tpuclip_torch.io.preprocess import naflex_target_size
    from tpuclip_torch.models.siglip import build_model
    from tpuclip_torch.ops._counters import COUNTED
    from tpuclip_torch.ops.graphs import FusedGraphs
    from tpuclip_torch.serve import SearchServer, warm_programs

    ops = mods[0]
    rows, m, scales = resident[:3]
    root, db, cache = work / "naflex_images", str(work / "naflex.db"), str(work / "models")
    write_naflex_jpegs(root)
    files = sorted(root.rglob("*.jpg"))
    grids = {f"{h}x{w}": "x".join(str(d // 16) for d in naflex_target_size(h, w, 16, 256))
             for h, w in NAFLEX_SIZES}
    check(len(set(grids.values())) == len(grids), f"two aspect families share a patch grid: {grids}")
    print(f"[naflex] wrote {len(files)} JPEGs; image (h x w) -> patch grid (h x w): {grids}", flush=True)

    env = {"TPUCLIP_SEARCH_PRECISION": "int8", "TPUCLIP_SEARCH_MODE": "exact", "TPUCLIP_DEVICE_RERANK": "1"}
    saved_env = {key: os.environ.get(key) for key in env}
    saved = (ImageDatabase.scan_directory, ImageDatabase.generate_html_gallery)
    scan_seconds, galleries, statuses = [], [], []

    def timed_scan(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = saved[0](self, *args, **kwargs)
        torch.cuda.synchronize()
        scan_seconds.append(time.perf_counter() - t0)
        return out

    query_file = files[7]
    model_args = ["--db", db, "--model", NAFLEX_MODEL, "--model-cache", cache]
    texts = [f"{TEXTS[i % len(TEXTS)]}, photo {i}" for i in range(16)]
    spread = [load_image(str(f)) for f in files[::12]]  # 16 images, every family
    b64 = [base64.b64encode(f.read_bytes()).decode() for f in files[3::37]]  # 5 uploads
    labels = ["a red car", "a photo of noise", "a city at night"]
    tail = (m, scales, rows, K, N_ROWS)
    graphs = FusedGraphs("cuda")
    cases = []
    os.environ.update(env)
    ImageDatabase.scan_directory = timed_scan
    ImageDatabase.generate_html_gallery = lambda self, results, *a, **kw: galleries.append(list(results))
    try:
        with search_runs(ops) as runs:
            for wrapper in COUNTED:
                wrapper.launches = 0
            cli.main(["scan", str(root), *model_args, "--inference-batch-size", "64"])
            cli.main(["search", "a red car", "-k", str(K), *model_args, "--no-session"])
            cli.main(["search", str(query_file), "--image", "-k", str(K), *model_args, "--no-session"])
            engine = ImageDatabase(db, cache, model_name=NAFLEX_MODEL, inference_batch_size=64)
            model = engine.model
            # The fused NaFlex programs over phase 3's 1M resident rows,
            # through a graph runner as the index's: warm-up, capture, replay.
            for kind, nt, ni in NAFLEX_PROGRAMS:
                host = list(engine._tokenize_bucketed(texts[:nt])) if nt else []
                host += engine._image_inputs(spread[:ni], ni)
                method = ops.resolve_shortlist_method(nt + ni)
                key = (kind, nt, ni, K, method)
                program = fused_program(ops, model, nt, tail, method)
                before = graphs.capture_seconds
                out = graphs.run(key, program, host)
                cases.append((key, program, host, out, graphs.capture_seconds - before))
            # serve on the NaFlex database.
            srv = SearchServer(engine, host="127.0.0.1", port=0)
            call = functools.partial(http_call, srv, statuses)
            t0 = time.perf_counter()
            warmed = warm_programs(engine, k=K)  # the requests' k: each replays a warm graph
            warm_s = time.perf_counter() - t0
            serve_graphs, n_warm = engine.index._graphs, len(engine.index._graphs)
            serve_pool = serve_graphs.pool_bytes()
            thread = srv.start_background()
            text = call("/search", {"query": "a yellow taxi", "k": K})
            upload = call("/search", {"image_b64": b64[0], "k": K})
            batch = call("/search_batch", {"queries": TEXTS, "k": K})
            embed = call("/embed", {"texts": TEXTS[:2], "images_b64": b64[:1]})
            classify = call("/classify", {"image_b64": b64[0], "labels": labels})
            burst_payloads = [{"query": q, "k": K} for q in TEXTS] + [{"image_b64": b, "k": K} for b in b64[1:5]]
            burst, mixed, engine_calls = serve_burst(srv, engine, call, burst_payloads)
            srv.shutdown()
            thread.join(timeout=30)
            torch.cuda.synchronize()
            launches = {wrapper.__name__: wrapper.launches for wrapper in COUNTED}
    finally:
        ImageDatabase.scan_directory, ImageDatabase.generate_html_gallery = saved
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    print(f"[naflex] kernel launches in this phase: {launches}; the fused search's runs: {runs}", flush=True)
    check(all(launches[name] == n > 0 for name, n in runs.items()),
          f"kernels 1 and 2 launched {launches}, not once per run of the search {runs}")
    check(launches["attention"] > 0 and launches["add_layer_norm"] > 0,
          f"the NaFlex towers did not launch kernels 9 and 10: {launches}")
    check(all(n == 0 for name, n in launches.items() if name not in runs and name not in TOWER_KERNELS),
          f"a kernel off the NaFlex path was launched: {launches}")
    check(not thread.is_alive() and not srv.batcher._thread.is_alive(), "the server did not shut down")
    check(all(code == 200 for code in statuses), f"statuses other than 200: {statuses}")

    # scan: every image stored, unit norm.
    check(len(scan_seconds) == 1, "scan did not run")
    rate = N_NAFLEX / scan_seconds[0]
    ids, vectors = engine.index.cache.load()
    vectors = np.array(vectors, np.float32)
    check(len(ids) == N_NAFLEX, f"{len(ids)} rows indexed, expected {N_NAFLEX}")
    norm_err = float(np.abs(np.linalg.norm(vectors, axis=1) - 1).max())
    check(norm_err <= 1e-3, f"NaFlex embeddings off unit norm by {norm_err}")
    paths = engine.store.fetch_paths_for_ids(ids)
    row_of = {paths[int(i)]: r for r, i in enumerate(ids)}
    pixels64 = [torch.from_numpy(x).cuda() for x in engine._image_inputs([load_image(str(f)) for f in files[:64]], 64)]
    vision_ms = p50_ms(lambda: model.get_image_features_naflex(*pixels64), 5)
    print(f"[naflex] scan: {N_NAFLEX} images in {scan_seconds[0]:.3f} s = {rate:.1f} images/s "
          f"(scan_directory, batch 64, so400m-patch16-naflex bf16 random weights); NaFlex vision tower "
          f"alone, batch 64 p50 {vision_ms:.2f} ms = {64e3 / vision_ms:.1f} images/s  ({gpu})", flush=True)

    # Batch invariance: each stored row (batch 64, pad rows in the last
    # batch) against the single-image path; bf16 on the card.
    single = np.stack([engine._embed_pil(load_image(paths[int(i)])) for i in ids])
    inv_err = float(np.abs(single - vectors).max())
    inv_cos = float(np.min(np.sum(single * vectors, axis=1)))
    check(inv_err <= 5e-3 and inv_cos >= 0.999,
          f"stored rows off the single-image path: max diff {inv_err}, min cosine {inv_cos}")
    # bf16 against the same weights in fp32 (TF32 off), at batch 64.
    f32 = build_model(engine.config, torch.device("cuda"), torch.float32)
    f32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    e16 = model.get_image_features_naflex(*pixels64).cpu().numpy()
    e32 = f32.get_image_features_naflex(*pixels64).cpu().numpy()
    del f32
    torch.cuda.empty_cache()
    f32_cos = float(np.min(np.sum(e16 * e32, axis=1)
                           / (np.linalg.norm(e16, axis=1) * np.linalg.norm(e32, axis=1))))
    check(f32_cos >= 0.999, f"the bf16 NaFlex tower against fp32: cosine {f32_cos} < 0.999")
    print(f"[naflex] stored rows against the single-image path: max diff {inv_err:.2e}, min cosine "
          f"{inv_cos:.6f}; bf16 tower against the same weights in fp32: min cosine {f32_cos:.6f}; "
          f"embeddings unit-norm (max error {norm_err:.2e})", flush=True)

    # CLI searches against a brute force over the stored rows.
    check(len(galleries) == 2, f"the CLI searches produced {len(galleries)} galleries, expected 2")
    rows_bf16 = torch.from_numpy(vectors).to(torch.bfloat16)
    check_brute_force(galleries[0], engine.embed_texts(["a red car"])[0], rows_bf16, row_of, "CLI text search")
    check_brute_force(galleries[1], engine._embed_pil(load_image(str(query_file))), rows_bf16, row_of,
                      "CLI search --image")
    check(galleries[1][0][0] == str(query_file), "search --image does not rank its own image first")
    print(f"[naflex] CLI search (text) and search --image: {len(galleries[0])} and {len(galleries[1])} "
          f"results in the brute-force order over the {N_NAFLEX} stored rows; the query image first",
          flush=True)

    # The fused programs: graph, eager and two-stage.
    report = []
    for key, program, host, (s_g, r_g), capture_s in cases:
        kind, nt, ni, _, method = key
        name = f"{kind} {nt}+{ni}" if nt else f"{kind} {ni}"
        dev = [torch.from_numpy(x).cuda() for x in host]
        s_e, r_e = (x.cpu().numpy() for x in program(*dev))
        parts = [model.get_text_features(*dev[:2]).cpu()] if nt else []
        parts.append(model.get_image_features_naflex(*dev[-3:]).cpu())
        s_2, r_2 = (x.cpu().numpy() for x in ops.topk_int8_rerank_fused_auto(
            torch.cat(parts).cuda(), m, scales, rows, K, n_valid=N_ROWS))
        check(np.array_equal(r_g, r_e) and np.array_equal(r_g, r_2),
              f"fused {name}: graph, eager and two-stage ids differ")
        check(np.array_equal(s_g, s_e), f"fused {name}: graph scores are not bit-equal to eager")
        err = float(np.abs(s_g - s_2).max())
        check(err <= 1e-6 and np.isfinite(s_g).all() and s_g.shape == (nt + ni, K),
              f"fused {name}: scores off the two-stage route by {err}, or shape {s_g.shape}")
        graph_ms = p50_ms(graphs._graphs[key].graph.replay, 20)
        eager_ms = p50_ms(lambda: program(*dev), 20)
        report.append({"program": name, "method": method, "graph_ms": graph_ms, "eager_ms": eager_ms,
                       "capture_s": capture_s, "max_err_two_stage": err})
        print(f"[naflex] fused {name} ({method}): ids identical (graph, eager, two-stage), graph bit-equal "
              f"to eager, max diff {err:.2e} to two-stage; device p50 graph {graph_ms:.4f} ms vs eager "
              f"{eager_ms:.4f} ms; capture {capture_s:.3f} s  ({gpu})", flush=True)
    pool_bytes = graphs.pool_bytes()
    print(f"[naflex] {len(graphs)} graphs over {N_ROWS:,} rows captured in {graphs.capture_seconds:.3f} s; "
          f"their pool holds {pool_bytes:,} bytes  ({gpu})", flush=True)
    del graphs, cases

    # serve: the warm matrix, then every answer against the two-stage route.
    check(warmed == 24 and n_warm == 21,
          f"warm_programs made {warmed} calls and {n_warm} graphs, expected 24 and 21")
    check(len(serve_graphs) == 21, f"the requests captured {len(serve_graphs) - 21} graph(s) past the warm matrix")
    errs = [same_served(engine, text["results"], engine.index.search_batch(engine.embed_texts(["a yellow taxi"]),
                                                                          K)[0], "text /search")]
    errs += check_served(engine, b64[0], upload, batch, embed, labels, classify, burst_payloads, burst, engine_calls)
    print(f"[naflex] serve: warm_programs {warmed} calls, {len(serve_graphs)} graphs in {warm_s:.3f} s "
          f"(capture {serve_graphs.capture_seconds:.3f} s), pool {serve_pool:,} bytes, each request a replay; "
          f"text /search, "
          f"image_b64 /search, 4-text /search_batch, /embed, /classify and a burst of 4 texts + 4 uploads "
          f"({mixed} mixed window(s)): {len(statuses)} responses, all 200, equal to the two-stage route "
          f"(max score diff {max(errs):.2e})  ({gpu})", flush=True)
    print("[phase11-json] " + json.dumps({
        "gpu": gpu, "grids": grids, "scan_images_per_s": rate, "scan_s": scan_seconds[0],
        "vision_batch64_ms": vision_ms, "batch_invariance_max_diff": inv_err,
        "batch_invariance_min_cos": inv_cos, "bf16_vs_fp32_min_cos": f32_cos, "programs": report,
        "pool_bytes": pool_bytes, "warm_calls": warmed, "warm_s": warm_s,
        "serve_capture_s": serve_graphs.capture_seconds, "serve_pool_bytes": serve_pool,
        "mixed_windows": mixed, "launches": launches}), flush=True)
    return launches


MODEL_384 = "google/siglip2-so400m-patch14-384"
N_384 = 128
# (height, width) of the 384 px phase's photos, resized to 384 x 384 by the
# scan: 4:3, 3:4, square and a small 3:2 that is scaled up.
SIZES_384 = [(480, 640), (640, 480), (384, 384), (200, 300)]
CELL_384 = "embed.so400m-384.b64"


def write_384_jpegs(root):
    """N_384 seeded JPEGs, the sizes in turn, one folder each."""
    from PIL import Image

    rng = np.random.default_rng(17)
    for i in range(N_384):
        h, w = SIZES_384[i % len(SIZES_384)]
        folder = root / f"{h}x{w}"
        folder.mkdir(parents=True, exist_ok=True)
        arr = np.clip(rng.integers(0, 256, (1, 1, 3)) + rng.integers(-40, 40, (h, w, 3)), 0, 255)
        Image.fromarray(arr.astype(np.uint8)).save(folder / f"img_{i:04d}.jpg", quality=90)


def phase_so400m_384(mods, gpu, work, resident):
    """Phase 17: SigLIP2 so400m-patch14-384 (729 tokens) end to end;
    returns every counted kernel's launches in the phase."""
    from bench_port import weights
    from bench_port.reference import siglip_ref
    from bench_port.shapes import vision_shape
    from tpuclip_torch import cli
    from tpuclip_torch.engine import ImageDatabase
    from tpuclip_torch.io.decode import load_image
    from tpuclip_torch.io.preprocess import preprocess_batch
    from tpuclip_torch.ops._counters import COUNTED
    from tpuclip_torch.ops.graphs import FusedGraphs

    ops = mods[0]
    rows, m, scales = resident[:3]
    root, db, cache = work / "images_384", str(work / "so400m_384.db"), str(work / "models")
    write_384_jpegs(root)
    files = sorted(root.rglob("*.jpg"))
    print(f"[so400m-384] wrote {len(files)} JPEGs of {SIZES_384} (h x w)", flush=True)

    saved = (ImageDatabase.scan_directory, ImageDatabase.generate_html_gallery)
    scan_seconds, galleries = [], []

    def timed_scan(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = saved[0](self, *args, **kwargs)
        torch.cuda.synchronize()
        scan_seconds.append(time.perf_counter() - t0)
        return out

    query_file = files[5]
    model_args = ["--db", db, "--model", MODEL_384, "--model-cache", cache]
    ImageDatabase.scan_directory = timed_scan
    ImageDatabase.generate_html_gallery = lambda self, results, *a, **kw: galleries.append(list(results))
    try:
        with environ(TPUCLIP_SEARCH_PRECISION="int8", TPUCLIP_SEARCH_MODE="exact", TPUCLIP_DEVICE_RERANK="1"):
            for wrapper in COUNTED:
                wrapper.launches = 0
            cli.main(["scan", str(root), *model_args, "--inference-batch-size", "64"])
            cli.main(["search", "a red car", "-k", str(K), *model_args, "--no-session"])
            cli.main(["search", str(query_file), "--image", "-k", str(K), *model_args, "--no-session"])
            engine = ImageDatabase(db, cache, model_name=MODEL_384, inference_batch_size=64)
            model = engine.model
            query = load_image(str(query_file))
            fused = engine.search_image_pil(query, K)  # the index's image graph at 384 x 384
            torch.cuda.synchronize()
            launches = {wrapper.__name__: wrapper.launches for wrapper in COUNTED}
    finally:
        ImageDatabase.scan_directory, ImageDatabase.generate_html_gallery = saved
    print(f"[so400m-384] kernel launches in this phase: {launches}", flush=True)
    check(launches["attention"] > 0 and launches["add_layer_norm"] > 0 and launches["int8_scores"] > 0,
          f"the 384 px towers or the int8 search did not launch their kernels: {launches}")
    check(engine.config.vision.num_patches == 729 and tuple(model.vision.pos_embed.shape) == (729, 1152),
          f"the 384 px preset is not 729 tokens at width 1152: {tuple(model.vision.pos_embed.shape)}")

    # scan: every image stored, unit norm; the CLI's searches against a brute force.
    check(len(scan_seconds) == 1, "scan did not run")
    rate = N_384 / scan_seconds[0]
    ids, vectors = engine.index.cache.load()
    vectors = np.array(vectors, np.float32)
    check(len(ids) == N_384, f"{len(ids)} rows indexed, expected {N_384}")
    norm_err = float(np.abs(np.linalg.norm(vectors, axis=1) - 1).max())
    check(norm_err <= 1e-3, f"384 px embeddings off unit norm by {norm_err}")
    paths = engine.store.fetch_paths_for_ids(ids)
    row_of = {paths[int(i)]: r for r, i in enumerate(ids)}
    rows_bf16 = torch.from_numpy(vectors).to(torch.bfloat16)
    check(len(galleries) == 2, f"the CLI searches produced {len(galleries)} galleries, expected 2")
    query_row = engine._embed_pil(query)
    check_brute_force(galleries[0], engine.embed_texts(["a red car"])[0], rows_bf16, row_of, "CLI text search")
    check_brute_force(galleries[1], query_row, rows_bf16, row_of, "CLI search --image")
    check(galleries[1][0][0] == str(query_file), "search --image does not rank its own image first")
    image_keys = [key for key in engine.index._graphs._graphs if key[0] == 0]  # (tb, ib, k, method)
    check(len(image_keys) == 1 and image_keys[0][1] == 1, f"search_image_pil captured no image graph: {image_keys}")
    two_stage = engine.index.search(query_row, K)
    check([p for p, _ in fused] == [p for p, _ in two_stage], "the fused image graph's ids differ from two-stage")
    graph_err = max(abs(a - b) for (_, a), (_, b) in zip(fused, two_stage))
    check(graph_err <= 1e-6, f"the fused image graph's scores are off the two-stage route by {graph_err}")
    print(f"[so400m-384] scan: {N_384} images in {scan_seconds[0]:.3f} s = {rate:.1f} images/s (scan_directory, "
          f"batch 64, so400m-patch14-384 bf16 random weights); CLI search (text) and search --image in the "
          f"brute-force order over the stored rows, the query image first; search_image_pil through the "
          f"index's image graph {image_keys[0]}: ids equal to the two-stage route, scores within "
          f"{graph_err:.2e}  ({gpu})", flush=True)

    # The benchmark's seeded weights in the engine's model: the fused image
    # program as a graph (its embedding kept: ``verified`` with
    # ``keep_scores``), eager, the engine's embedding entry and the plain
    # fp32 reference on the same pixels.
    root_dir = Path(__file__).resolve().parent
    config = json.loads((root_dir / "bench_port/configs/siglip2-so400m-patch14-384.json").read_text())
    limit = json.loads((root_dir / f"bench_port/limits/{CELL_384}.json").read_text())["max_row_dist"]
    shape = vision_shape(config)
    w = weights.make_vision_weights(shape, 2**31 + 384, model.vision.pos_embed.device, torch.bfloat16)
    weights.load_into_port(model, w, shape)
    pixels = preprocess_batch([load_image(str(f)) for f in files[:64]], engine.image_size)
    ref = siglip_ref.reference_rows(siglip_ref.fp32_weights(w), {"pixels": pixels}, np.arange(64), shape)
    ref = ref.cpu().numpy()
    del w

    def program(px):
        return ops.query_topk_fused(model, (), (px,), m, scales, rows, K, N_ROWS, shortlist_method="verified",
                                    keep_scores=True)

    def host(out):
        return out[0].cpu().numpy(), out[1].cpu().numpy(), out[4].cpu().numpy()

    graphs, report = FusedGraphs("cuda"), []
    for batch, first in ((16, 0), (16, 16), (1, 32)):  # the second batch replays the first's graph
        px = pixels[first : first + batch]
        key = ("image", 0, batch, K, "verified")
        s_g, r_g, emb_g = graphs.run(key, program, [px], host)
        s_e, r_e, emb_e = host(program(torch.from_numpy(px).cuda()))
        check(np.array_equal(emb_g, emb_e) and np.array_equal(s_g, s_e) and np.array_equal(r_g, r_e),
              f"image graph at batch {batch}: not bit-equal to eager")
        dist = float(np.linalg.norm(emb_g.astype(np.float64) - ref[first : first + batch], axis=1).max())
        check(dist <= limit, f"image graph at batch {batch}: rows {dist} from the fp32 reference (limit {limit})")
        report.append({"batch": batch, "first": first, "max_row_dist": dist})
    check(len(graphs) == 2, f"{len(graphs)} image graphs captured, expected 2 (batches 16 and 1)")
    graph_ms = {b: p50_ms(graphs._graphs[("image", 0, b, K, "verified")].graph.replay, 20) for b in (1, 16)}
    dev_pixels = torch.from_numpy(pixels).cuda()
    eager_ms = {b: p50_ms(lambda: program(dev_pixels[:b]), 20) for b in (1, 16)}
    del graphs
    rows_engine = engine.embed_images_uint8(pixels)
    engine_dist = float(np.linalg.norm(rows_engine.astype(np.float64) - ref, axis=1).max())
    check(engine_dist <= limit, f"embed_images_uint8: rows {engine_dist} from the fp32 reference (limit {limit})")
    vision_ms = p50_ms(lambda: model.get_image_features(dev_pixels), 5)
    print(f"[so400m-384] the benchmark's seeded weights: the fused image program as a graph at batch 16 (twice, "
          f"one capture) and 1, bit-equal to eager; its rows against the plain fp32 reference max "
          f"{max(r['max_row_dist'] for r in report):.4f}, embed_images_uint8's (batch 64) {engine_dist:.4f} "
          f"(the cell's limit {limit}); device p50 graph {graph_ms[1]:.4f} / {graph_ms[16]:.4f} ms, eager "
          f"{eager_ms[1]:.4f} / {eager_ms[16]:.4f} ms (batch 1 / 16, over {N_ROWS:,} rows); vision tower "
          f"alone, batch 64 p50 {vision_ms:.2f} ms = {64e3 / vision_ms:.1f} images/s  ({gpu})", flush=True)
    print("[phase17-json] " + json.dumps({
        "gpu": gpu, "scan_images_per_s": rate, "scan_s": scan_seconds[0], "fused_graph_max_err": graph_err,
        "graphs": report, "graph_ms": graph_ms, "eager_ms": eager_ms, "engine_max_row_dist": engine_dist,
        "limit": limit, "vision_batch64_ms": vision_ms, "launches": launches}), flush=True)
    return launches


MODEL_DINOV2 = "facebook/dinov2-with-registers-giant"
CELL_DINOV2 = "embed.dinov2-g-518.b32"
N_DINOV2 = 64
GATE_ROWS = 32 * 1374  # one b32 call's token rows
GATE_HIDDEN = 4096
DINOV2_DIM = 1536


def bf16_steps(got, want):
    """(whether each value of ``got`` is within one bf16 step of ``want``,
    plus 1e-5 near zero; the largest difference; the share bit-equal)."""
    g, w = got.float(), want.float()
    _, exp = torch.frexp(w)
    err = (g - w).abs()
    ok = bool((err <= torch.ldexp(torch.ones_like(w), exp - 8) + 1e-5).all())
    return ok, err.max().item(), float((err == 0).float().mean())


def phase_dinov2_kernels(lops, sops, gpu):
    """Phase 18 (a): kernel 11 and kernel 10 with a scale at the DINOv2
    cell's size, each alone after an L2 flush; returns kernel 11's record
    with kernel 10's scaled and unscaled cases at D 1536 under
    ``add_layer_norm_d1536``."""
    from tpuclip_torch.ops._build import library

    dev = torch.device("cuda")
    lib = library()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev).zero_
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(18)
    rows, h = GATE_ROWS, GATE_HIDDEN
    x = (torch.randn((rows, 2 * h), generator=gen, device=dev) * 3).to(torch.bfloat16)
    out = torch.empty((rows, h), dtype=torch.bfloat16, device=dev)
    got, want = sops.silu_mul(x), sops.silu_mul_plain(x)
    ok, worst, equal = bf16_steps(got, want)
    check(ok, f"silu_mul: more than one bf16 step off its plain version (max diff {worst:.2e})")

    def kernel():
        check(lib.tpuclip_silu_mul(x.data_ptr(), out.data_ptr(), rows, h, stream) == 0, "silu_mul launch failed")

    kernel_ms = cold_p50_ms(kernel, 20, flush)
    ms = cold_p50_ms(lambda: sops.silu_mul(x), 20, flush)
    plain = cold_p50_ms(lambda: sops.silu_mul_plain(x), 20, flush)
    a, b = x[:, :h], x[:, h:]
    nearest = cold_p50_ms(lambda: torch.nn.functional.silu(a) * b, 20, flush)
    n_bytes = rows * 3 * h * 2
    record = {**entry(worst, ms, plain, n_bytes, 0, "bf16", "F.silu(a) * b (bf16 halves)", nearest),
              "kernel_ms": kernel_ms, "bit_equal_share": equal}
    record["bound_share"] = record["bound_ms"] / kernel_ms
    print(f"[dinov2] silu_mul (kernel 11) M={rows:,} H={h}: within one bf16 step of the plain version (max diff "
          f"{worst:.2e}, {100 * equal:.4f}% bit-equal); kernel alone p50 {kernel_ms:.4f} ms, "
          f"{100 * record['bound_share']:.1f}% of the byte bound {record['bound_ms']:.4f} ms "
          f"({n_bytes / kernel_ms / 1e6:.0f} GB/s); wrapper {ms:.4f} ms; plain {plain:.4f} ms; F.silu(a) * b "
          f"{nearest:.4f} ms (L2 flushed before each launch)  ({gpu})", flush=True)
    del x, out, got, want, a, b
    torch.cuda.empty_cache()

    d, eps = DINOV2_DIM, 1e-6
    x = (torch.randn((rows, d), generator=gen, device=dev) * 3).to(torch.bfloat16)
    delta = (torch.randn((rows, d), generator=gen, device=dev) * 4).to(torch.bfloat16)
    gamma = (0.1 + 0.03 * torch.randn(d, generator=gen, device=dev)).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(torch.bfloat16)
    bias = (0.1 * torch.randn(d, generator=gen, device=dev)).to(torch.bfloat16)
    x_out, y = torch.empty_like(x), torch.empty_like(x)
    cases = {}
    for scale in (gamma, None):
        got_x, got_y = lops.add_layer_norm(x, delta, w, bias, eps, scale)
        want_x, want_y = lops.add_layer_norm_plain(x, delta, w, bias, eps, scale)
        check(torch.equal(got_x, want_x), f"add_layer_norm D={d} scale={scale is not None}: x_out is not the plain sum")
        ok, worst, equal = bf16_steps(got_y, want_y)
        check(ok, f"add_layer_norm D={d}: y more than one bf16 step off (max diff {worst:.2e})")
        args = (x.data_ptr(), delta.data_ptr(), 0 if scale is None else gamma.data_ptr(), w.data_ptr(),
                bias.data_ptr(), x_out.data_ptr(), y.data_ptr(), rows, d, eps, stream)

        def kernel(args=args):
            check(lib.tpuclip_add_layernorm(*args) == 0, "add_layernorm launch failed")

        k_ms = cold_p50_ms(kernel, 20, flush)
        plain = cold_p50_ms(lambda: lops.add_layer_norm_plain(x, delta, w, bias, eps, scale), 20, flush)
        n_bytes = rows * d * 2 * 4 + (3 if scale is not None else 2) * d * 2
        case = {**entry(worst, None, plain, n_bytes, 0, "bf16"), "kernel_ms": k_ms, "bit_equal_share": equal}
        case["bound_share"] = case["bound_ms"] / k_ms
        cases["scaled" if scale is not None else "unscaled"] = case
        print(f"[dinov2] add_layer_norm (kernel 10) rows={rows:,} D={d} x + {'gamma * ' if scale is not None else ''}"
              f"delta: x_out bit-equal to the plain sum, y within one bf16 step (max diff {worst:.2e}); kernel "
              f"alone p50 {k_ms:.4f} ms, {100 * case['bound_share']:.1f}% of the byte bound {case['bound_ms']:.4f} "
              f"ms; plain {plain:.4f} ms (L2 flushed before each launch)  ({gpu})", flush=True)
    del x, delta, x_out, y
    torch.cuda.empty_cache()
    record["add_layer_norm_d1536"] = cases
    record["ptxas"] = ptxas_report(gpu, "silu_mul.cu", r"(silu_mul_kernel)", "{}")
    return record


def write_dinov2_jpegs(root):
    """N_DINOV2 seeded JPEGs of two sizes, one folder each."""
    from PIL import Image

    rng = np.random.default_rng(18)
    for i in range(N_DINOV2):
        h, w = ((600, 800), (518, 518))[i % 2]
        folder = root / f"{h}x{w}"
        folder.mkdir(parents=True, exist_ok=True)
        arr = np.clip(rng.integers(0, 256, (1, 1, 3)) + rng.integers(-40, 40, (h, w, 3)), 0, 255)
        Image.fromarray(arr.astype(np.uint8)).save(folder / f"img_{i:04d}.jpg", quality=90)


def phase_dinov2(gpu, work):
    """Phase 18 (b): DINOv2-g with registers end to end; returns every
    counted kernel's launches in the phase."""
    from bench_port.drivers import embed_dinov2
    from bench_port.flops_dinov2 import dinov2_shape
    from bench_port.reference import dinov2_ref, siglip_ref
    from tpuclip_torch import cli
    from tpuclip_torch.engine import ImageDatabase
    from tpuclip_torch.io.decode import load_image
    from tpuclip_torch.io.preprocess import preprocess_batch
    from tpuclip_torch.ops._counters import COUNTED

    root, db, cache = work / "images_dinov2", str(work / "dinov2.db"), str(work / "models")
    write_dinov2_jpegs(root)
    files = sorted(root.rglob("*.jpg"))
    query_file = files[7]
    model_args = ["--db", db, "--model", MODEL_DINOV2, "--model-cache", cache]
    saved = (ImageDatabase.scan_directory, ImageDatabase.generate_html_gallery)
    scan_seconds, galleries = [], []

    def timed_scan(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = saved[0](self, *args, **kwargs)
        torch.cuda.synchronize()
        scan_seconds.append(time.perf_counter() - t0)
        return out

    ImageDatabase.scan_directory = timed_scan
    ImageDatabase.generate_html_gallery = lambda self, results, *a, **kw: galleries.append(list(results))
    try:
        with environ(TPUCLIP_SEARCH_PRECISION="int8", TPUCLIP_SEARCH_MODE="exact", TPUCLIP_DEVICE_RERANK="1",
                     TPUCLIP_INIT="random"):
            for wrapper in COUNTED:
                wrapper.launches = 0
            cli.main(["scan", str(root), *model_args, "--inference-batch-size", "32"])
            cli.main(["search", str(query_file), "--image", "-k", str(K), *model_args, "--no-session"])
            try:
                cli.main(["search", "a red car", "-k", str(K), *model_args, "--no-session"])
                refused = None
            except SystemExit as e:
                refused = e.code
            engine = ImageDatabase(db, cache, model_name=MODEL_DINOV2, inference_batch_size=32)
            model = engine.model
            query = load_image(str(query_file))
            fused = engine.search_image_pil(query, K)  # the index's image graph at 518 x 518
            torch.cuda.synchronize()
            launches = {wrapper.__name__: wrapper.launches for wrapper in COUNTED}
    finally:
        ImageDatabase.scan_directory, ImageDatabase.generate_html_gallery = saved
    print(f"[dinov2] kernel launches in this phase: {launches}", flush=True)
    check(refused == 2, f"a text search of the image-only model exited with {refused!r}, not 2")
    check(launches["silu_mul"] > 0 and launches["add_layer_norm"] > 0 and launches["attention_sm90"] > 0,
          f"the DINOv2 tower did not launch kernels 9, 10 and 11: {launches}")
    check(engine.tokenizer is None and engine.embedding_dim == DINOV2_DIM,
          f"the image-only engine: tokenizer {engine.tokenizer!r}, {engine.embedding_dim}-d")
    check(len(scan_seconds) == 1, "scan did not run")
    rate = N_DINOV2 / scan_seconds[0]
    ids, vectors = engine.index.cache.load()
    vectors = np.array(vectors, np.float32)
    check(len(ids) == N_DINOV2 and vectors.shape[1] == DINOV2_DIM, f"{vectors.shape} rows indexed")
    norm_err = float(np.abs(np.linalg.norm(vectors, axis=1) - 1).max())
    check(norm_err <= 1e-3, f"DINOv2 embeddings off unit norm by {norm_err}")
    paths = engine.store.fetch_paths_for_ids(ids)
    row_of = {paths[int(i)]: r for r, i in enumerate(ids)}
    check(len(galleries) == 1, f"the CLI image search produced {len(galleries)} galleries, expected 1")
    query_row = engine._embed_pil(query)
    check_brute_force(galleries[0], query_row, torch.from_numpy(vectors).to(torch.bfloat16), row_of,
                      "CLI search --image")
    check(galleries[0][0][0] == str(query_file), "search --image does not rank its own image first")
    two_stage = engine.index.search(query_row, K)
    check([p for p, _ in fused] == [p for p, _ in two_stage], "the fused image graph's ids differ from two-stage")
    graph_err = max(abs(a - b) for (_, a), (_, b) in zip(fused, two_stage))
    check(graph_err <= 1e-6, f"the fused image graph's scores are off the two-stage route by {graph_err}")
    counts = {wrapper.__name__: wrapper.launches for wrapper in COUNTED}
    pixels = preprocess_batch([load_image(str(f)) for f in files[:32]], engine.image_size)
    dev_pixels = torch.from_numpy(pixels).cuda()
    model.get_image_features(dev_pixels)
    per_call = {w.__name__: w.launches - counts[w.__name__] for w in COUNTED}
    check(per_call["add_layer_norm"] == 81 and per_call["silu_mul"] == 40,
          f"a tower call launched {per_call['add_layer_norm']} kernel-10 and {per_call['silu_mul']} kernel-11 "
          "kernels, expected 81 and 40")
    print(f"[dinov2] scan: {N_DINOV2} images in {scan_seconds[0]:.3f} s = {rate:.1f} images/s (scan_directory, "
          f"batch 32, dinov2-with-registers-giant bf16 random weights, 1536-d rows); CLI search --image in the "
          f"brute-force order, the query image first; a text search refused (exit 2); search_image_pil through "
          f"the index's image graph: ids equal to the two-stage route, scores within {graph_err:.2e}; a tower "
          f"call launches kernel 10 81 times and kernel 11 40 times  ({gpu})", flush=True)

    root_dir = Path(__file__).resolve().parent
    config = json.loads((root_dir / "bench_port/configs/dinov2-with-registers-giant.json").read_text())
    limit = json.loads((root_dir / f"bench_port/limits/{CELL_DINOV2}.json").read_text())["max_row_dist"]
    shape = dinov2_shape(config)
    w = embed_dinov2.make_weights(shape, 2**31 + 518, dev_pixels.device, torch.bfloat16)
    embed_dinov2.load_into_port(model, w)
    rows_engine = engine.embed_images_uint8(pixels)
    vision_ms = p50_ms(lambda: model.get_image_features(dev_pixels), 5)
    del engine, model, dev_pixels
    torch.cuda.empty_cache()
    ref = dinov2_ref.reference_rows(siglip_ref.fp32_weights(w), pixels, np.arange(32), shape).cpu().numpy()
    del w
    dist = float(np.linalg.norm(rows_engine.astype(np.float64) - ref, axis=1).max())
    check(dist <= limit, f"embed_images_uint8: rows {dist} from the fp32 reference (limit {limit})")
    print(f"[dinov2] the benchmark's seeded weights: embed_images_uint8's rows (batch 32) against the plain fp32 "
          f"reference max {dist:.4f} (the cell's limit {limit}); vision tower alone, batch 32 p50 "
          f"{vision_ms:.2f} ms = {32e3 / vision_ms:.1f} images/s  ({gpu})", flush=True)
    print("[phase18-json] " + json.dumps({
        "gpu": gpu, "scan_images_per_s": rate, "scan_s": scan_seconds[0], "fused_graph_max_err": graph_err,
        "engine_max_row_dist": dist, "limit": limit, "vision_batch32_ms": vision_ms, "launches": launches}),
        flush=True)
    return launches


MODEL_DINOV3 = "facebook/dinov3-vit7b16-pretrain-lvd1689m"
CELL_DINOV3 = "embed.dinov3-7b-512.b16"
N_DINOV3 = 32
DINOV3_ROWS = 16 * 1029  # one b16 call's token rows


def phase_dinov3_kernels(lops, gpu):
    """Phase 19 (a): kernel 12 at one b16 call of the DINOv3 cell (16 x
    1,029 tokens, 32 heads of 128) and kernel 10 with γ at width 4096 (its
    wide design), each alone after an L2 flush, against their byte bounds;
    returns kernel 12's record with kernel 10's under
    ``add_layer_norm_d4096``."""
    from tpuclip_torch.models import dinov3
    from tpuclip_torch.ops import rope as rops
    from tpuclip_torch.ops._build import library

    dev = torch.device("cuda")
    lib = library()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev).zero_
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(19)
    cfg = dinov3.get_config(MODEL_DINOV3).vision
    b, s, d, heads, prefix = 16, cfg.num_tokens, cfg.hidden_size, cfg.num_heads, cfg.num_prefix_tokens
    angles = dinov3.rope_angles(cfg, 32, 32)
    cos, sin = torch.cos(angles).to(dev), torch.sin(angles).to(dev)
    q, k = ((torch.randn((b, s, d), generator=gen, device=dev) * 2).to(torch.bfloat16) for _ in range(2))
    want = rops.rope_plain(q, k, cos, sin, heads, prefix)
    got = rops.rope(q.clone(), k.clone(), cos, sin, heads, prefix)
    check(all(torch.equal(g, w) for g, w in zip(got, want)), "rope: the kernel is not bit-equal to its plain version")

    def kernel():
        check(lib.tpuclip_rope2d(q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(), b, s, prefix, d,
                                 d // heads, stream) == 0, "rope2d launch failed")

    kernel_ms = cold_p50_ms(kernel, 20, flush)
    plain = cold_p50_ms(lambda: rops.rope_plain(q, k, cos, sin, heads, prefix), 20, flush)
    n_bytes = 2 * 2 * b * (s - prefix) * d * 2
    record = {**entry(0.0, None, plain, n_bytes, 0, "bf16"), "kernel_ms": kernel_ms, "bit_equal_share": 1.0}
    record["bound_share"] = record["bound_ms"] / kernel_ms
    print(f"[dinov3] rope (kernel 12) B={b} S={s} {heads} x {d // heads}: bit-equal to the plain version; kernel "
          f"alone p50 {kernel_ms:.4f} ms, {100 * record['bound_share']:.1f}% of the byte bound "
          f"{record['bound_ms']:.4f} ms; plain {plain:.4f} ms (L2 flushed before each launch)  ({gpu})", flush=True)
    del q, k, got, want
    torch.cuda.empty_cache()

    rows, eps = DINOV3_ROWS, cfg.layer_norm_eps
    x = (torch.randn((rows, d), generator=gen, device=dev) * 3).to(torch.bfloat16)
    delta = (torch.randn((rows, d), generator=gen, device=dev) * 4).to(torch.bfloat16)
    gamma = (0.1 + 0.03 * torch.randn(d, generator=gen, device=dev)).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(torch.bfloat16)
    bias = (0.1 * torch.randn(d, generator=gen, device=dev)).to(torch.bfloat16)
    got_x, got_y = lops.add_layer_norm(x, delta, w, bias, eps, gamma)
    want_x, want_y = lops.add_layer_norm_plain(x, delta, w, bias, eps, gamma)
    check(torch.equal(got_x, want_x), f"add_layer_norm D={d}: x_out is not the plain sum")
    ok, worst, equal = bf16_steps(got_y, want_y)
    check(ok, f"add_layer_norm D={d}: y more than one bf16 step off (max diff {worst:.2e})")
    x_out, y = torch.empty_like(x), torch.empty_like(x)
    args = (x.data_ptr(), delta.data_ptr(), gamma.data_ptr(), w.data_ptr(), bias.data_ptr(), x_out.data_ptr(),
            y.data_ptr(), rows, d, eps, stream)
    k_ms = cold_p50_ms(lambda: check(lib.tpuclip_add_layernorm(*args) == 0, "add_layernorm launch failed"), 20, flush)
    n_bytes = rows * d * 2 * 4 + 3 * d * 2
    case = {**entry(worst, None, None, n_bytes, 0, "bf16"), "kernel_ms": k_ms, "bit_equal_share": equal}
    case["bound_share"] = case["bound_ms"] / k_ms
    print(f"[dinov3] add_layer_norm (kernel 10, wide design) rows={rows:,} D={d} x + gamma * delta: x_out bit-equal "
          f"to the plain sum, y within one bf16 step (max diff {worst:.2e}); kernel alone p50 {k_ms:.4f} ms, "
          f"{100 * case['bound_share']:.1f}% of the byte bound {case['bound_ms']:.4f} ms  ({gpu})", flush=True)
    del x, delta, x_out, y, got_x, got_y, want_x, want_y
    torch.cuda.empty_cache()
    record["add_layer_norm_d4096"] = case
    return record


def phase_dinov3(gpu, work):
    """Phase 19 (b): DINOv3-7B end to end, short: scan, search by image and
    a refused text search at 512 px, a tower call's launches, and the
    benchmark's seeded weights against ``bench_port/reference/dinov3_ref.py``;
    returns every counted kernel's launches on the scan and search path."""
    from bench_port.drivers import embed_dinov3
    from bench_port.flops_dinov3 import dinov3_shape
    from bench_port.reference import dinov3_ref, siglip_ref
    from tpuclip_torch import cli
    from tpuclip_torch.engine import ImageDatabase
    from tpuclip_torch.io.decode import load_image
    from tpuclip_torch.io.preprocess import preprocess_batch
    from tpuclip_torch.ops._counters import COUNTED

    from PIL import Image

    root, db, cache = work / "images_dinov3", str(work / "dinov3.db"), str(work / "models")
    rng = np.random.default_rng(19)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(N_DINOV3):
        h, w = ((480, 640), (512, 512))[i % 2]
        arr = np.clip(rng.integers(0, 256, (1, 1, 3)) + rng.integers(-40, 40, (h, w, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(arr).save(root / f"img_{i:04d}.jpg", quality=90)
    files = sorted(root.glob("*.jpg"))
    model_args = ["--db", db, "--model", MODEL_DINOV3, "--model-cache", cache]
    with environ(TPUCLIP_SEARCH_PRECISION="int8", TPUCLIP_SEARCH_MODE="exact", TPUCLIP_DEVICE_RERANK="1",
                 TPUCLIP_INIT="random"):
        for wrapper in COUNTED:
            wrapper.launches = 0
        t0 = time.perf_counter()
        cli.main(["scan", str(root), *model_args, "--inference-batch-size", "16"])
        scan_s = time.perf_counter() - t0
        try:
            cli.main(["search", "a red car", "-k", str(K), *model_args, "--no-session"])
            refused = None
        except SystemExit as e:
            refused = e.code
        engine = ImageDatabase(db, cache, model_name=MODEL_DINOV3, inference_batch_size=16)
        query = load_image(str(files[5]))
        found = engine.search_image_pil(query, K)
        torch.cuda.synchronize()
        launches = {wrapper.__name__: wrapper.launches for wrapper in COUNTED}
    print(f"[dinov3] kernel launches in this phase: {launches}", flush=True)
    check(refused == 2, f"a text search of the image-only model exited with {refused!r}, not 2")
    check(found[0][0] == str(files[5]), "search by image does not rank its own image first")
    ids, _ = engine.index.cache.load()
    check(len(ids) == N_DINOV3, f"{len(ids)} rows indexed, expected {N_DINOV3}")
    model = engine.model
    pixels = preprocess_batch([load_image(str(f)) for f in files[:16]], engine.image_size)
    dev_pixels = torch.from_numpy(pixels).cuda()
    counts = {wrapper.__name__: wrapper.launches for wrapper in COUNTED}
    model.get_image_features(dev_pixels)
    per_call = {w.__name__: w.launches - counts[w.__name__] for w in COUNTED}
    want = {"add_layer_norm": 81, "silu_mul": 40, "rope": 40, "attention": 40, "attention_sm90": 40}
    check(all(per_call[n] == v for n, v in want.items()), f"a tower call launched {per_call}, expected {want}")
    root_dir = Path(__file__).resolve().parent
    config = json.loads((root_dir / "bench_port/configs/dinov3-vit7b16-pretrain-lvd1689m.json").read_text())
    limits = json.loads((root_dir / f"bench_port/limits/{CELL_DINOV3}.json").read_text())
    shape = dinov3_shape(config)
    w = embed_dinov3.make_weights(shape, 2**31 + 512, dev_pixels.device, torch.bfloat16)
    embed_dinov3.load_into_port(model, w)
    rows_engine = engine.embed_images_uint8(pixels)
    vision_ms = p50_ms(lambda: model.get_image_features(dev_pixels), 5)
    del engine, model, dev_pixels
    torch.cuda.empty_cache()
    ref = dinov3_ref.reference_rows(siglip_ref.fp32_weights(w), pixels, np.arange(16), shape).cpu().numpy()
    del w
    dist = np.linalg.norm(rows_engine.astype(np.float64) - ref, axis=1)
    check(dist.max() <= limits["max_row_dist"] and np.median(dist) <= limits["median_row_dist"],
          f"embed_images_uint8: rows {dist.max()} (median {np.median(dist)}) from the fp32 reference, over {limits}")
    print(f"[dinov3] scan of {N_DINOV3} JPEGs at 512 px in {scan_s:.1f} s (with model init), search by image "
          f"ranks its image first, a text search refused (exit 2); a tower call launches kernel 10 81 times, kernels "
          f"11, 12 and 9 (Hopper, hd 128) 40 times each; the benchmark's seeded weights: rows (batch 16) against "
          f"the plain fp32 reference max {dist.max():.4f}, median {np.median(dist):.4f} (limits "
          f"{limits['max_row_dist']}, {limits['median_row_dist']}); tower alone, batch 16 p50 {vision_ms:.1f} ms = "
          f"{16e3 / vision_ms:.1f} images/s  ({gpu})", flush=True)
    print("[phase19-json] " + json.dumps({
        "gpu": gpu, "scan_s": scan_s, "engine_max_row_dist": float(dist.max()),
        "engine_median_row_dist": float(np.median(dist)), "limits": limits, "vision_batch16_ms": vision_ms,
        "per_call": per_call, "launches": launches}), flush=True)
    return launches


def fused_program(ops, model, n_texts, tail, method):
    """``query_topk_fused`` over the resident ``tail`` (m, scales, rows, k,
    n_valid) as a function of its host inputs: the texts' ids and mask
    first when ``n_texts``, then the vision tower's inputs."""
    t = 2 if n_texts else 0
    return lambda *x: ops.query_topk_fused(model, x[:t], x[t:], *tail, shortlist_method=method)


# IVF at the main path's size (phase 12): tests/test_ivf.py's mixture on the
# sphere at 1152-d, with per-dimension noise scaled so the noise norm keeps
# its ~0.4 of a centre's (0.05 at 64-d).
N_IVF_CENTRES = 1024
IVF_SPREAD = 0.05 * (64 / DIM) ** 0.5
IVF_QUERY_COUNTS = (1, 4, 16, 64)


def clustered_rows(rng, centres, out, chunk=65536):
    """Fills ``out`` (n, D) on the card with unit rows of the mixture: a
    seeded numpy centre per row plus Gaussian noise, normalised."""
    n = out.shape[0]
    for s in range(0, n, chunk):
        c = min(chunk, n - s)
        x = centres[rng.integers(0, len(centres), c)] + IVF_SPREAD * rng.standard_normal((c, DIM), dtype=np.float32)
        x = torch.from_numpy(x).to(out.device)
        out[s : s + c] = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return out


def device_breakdown(fn, runs=3, top=6):
    """torch.profiler (CPU and CUDA activity) over ``runs`` calls of ``fn``
    after one warm-up: (wall ms a call, the device's busy ms a call, i.e.
    the sum of its kernels' times, kernel launches a call, [(kernel name,
    device ms a call)] for the ``top`` kernels by device time). Busy is
    None when the profiler saw no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / runs
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return wall, None, 0, []
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / runs
    launches = sum(e.count for e in kernels) / runs
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    return wall, busy, launches, [(e.key[:70], e.self_device_time_total / 1e3 / runs) for e in ranked]


def print_breakdown(tag, what, breakdown, gpu):
    wall, busy, launches, ranked = breakdown
    if busy is None:
        print(f"[{tag}] {what}: wall {wall:.3f} ms a call; the profiler saw no device time  ({gpu})", flush=True)
        return
    print(f"[{tag}] {what}: wall {wall:.3f} ms a call, device busy {busy:.3f} ms ({busy / wall:.0%}; idle "
          f"{1 - busy / wall:.0%}), {launches:.0f} kernel launches a call; by device time: "
          + "; ".join(f"{name} {ms:.3f}" for name, ms in ranked) + f"  ({gpu})", flush=True)


def reaches_every_row_once(index, n):
    ids = torch.cat([index.bucket_rows.reshape(-1), index.over_rows]).long()
    ids = ids[ids >= 0]
    return ids.numel() == n and int(torch.bincount(ids, minlength=n).max()) == 1


def phase_ivf(mods, gpu, work, db):
    """Phase 12: IVF at full width, then ``--mode ivf`` through the CLI and
    ``serve`` on phase 4's database; returns every counted kernel's
    launches on the IVF path, and the mixture's rows, queries, index and
    exact results, which phase 14 shards."""
    import base64

    from tpuclip_torch import cli
    from tpuclip_torch.engine import ImageDatabase
    from tpuclip_torch.index import ivf as ivf_mod
    from tpuclip_torch.index.dedup import filter_duplicates
    from tpuclip_torch.io.decode import load_image_bytes
    from tpuclip_torch.ops._counters import COUNTED
    from tpuclip_torch.serve import SearchServer

    ops = mods[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    centres = rng.standard_normal((N_IVF_CENTRES, DIM), dtype=np.float32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    n_more = N_ROWS // 10  # the append: under the 20% that triggers a retraining
    rows_all = clustered_rows(rng, centres, torch.empty((N_ROWS + n_more, DIM), dtype=torch.bfloat16, device=dev))
    rows = rows_all[:N_ROWS]
    queries = clustered_rows(rng, centres, torch.empty((max(IVF_QUERY_COUNTS), DIM), device=dev))
    n_pad = -(-N_ROWS // ops.INT8_TILE_N) * ops.INT8_TILE_N
    m, scales = ops.derive_int8_matrix(rows, n_pad)
    torch.cuda.synchronize()
    print(f"[ivf] {N_ROWS:,} x {DIM} clustered unit rows ({N_IVF_CENTRES} centres, noise {IVF_SPREAD:.4f} a "
          f"dimension) resident: bf16 + int8 matrix", flush=True)

    # The exact fused search on the same rows, outside the counted window.
    exact, exact_ms = {}, {}
    for q_count in IVF_QUERY_COUNTS:
        q = queries[:q_count]

        def fused():
            return ops.topk_int8_rerank_fused_auto(q, m, scales, rows, K, n_valid=N_ROWS)

        exact[q_count] = fused()
        exact_ms[q_count] = p50_ms(fused, 20)

    def exact_of(q, ids):
        """The exact path's score of each returned row: the bf16-rounded
        query against the bf16 row in f32, as its rescore computes it."""
        qr = ops.round_f32_to_bf16_bits(q)
        return (rows[ids.clamp_min(0)].float() * qr[:, None, :]).sum(-1)

    probes = [0]
    real_rerank = ivf_mod.ivf_topk_rerank

    def counted_rerank(q_f32, *args):
        probes[0] += q_f32.shape[0] + 1  # kernel 1 once a query, once on the overflow block
        return real_rerank(q_f32, *args)

    cache = str(work / "models")
    files = sorted((work / "images").rglob("*.jpg"))
    saved_env = {key: os.environ.get(key) for key in ("TPUCLIP_SEARCH_MODE", "TPUCLIP_DEVICE_RERANK")}
    saved_gallery = ImageDatabase.generate_html_gallery
    galleries, statuses, report = [], [], {}
    for wrapper in COUNTED:
        wrapper.launches = 0
    ivf_mod.ivf_topk_rerank = counted_rerank
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = ivf_mod.build_ivf_device(rows)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        k_clusters, cap = index.bucket_rows.shape
        overflow = int((index.over_rows >= 0).sum())
        check(reaches_every_row_once(index, N_ROWS), "the IVF build lost or repeated a row")
        print(f"[ivf] build_ivf_device: K {k_clusters}, C {cap}, nprobe {index.nprobe}, overflow {overflow:,} "
              f"rows (block {index.over_rows.numel():,}), {index.nbytes():,} bytes on the card, "
              f"{build_s:.3f} s  ({gpu})", flush=True)
        t0 = time.perf_counter()
        grown = ivf_mod.build_ivf_device(rows_all, k_clusters=k_clusters, centroids=index.centroids)
        torch.cuda.synchronize()
        reuse_s = time.perf_counter() - t0
        check(torch.equal(grown.centroids, index.centroids) and reaches_every_row_once(grown, len(rows_all)),
              "the rebuild after the append retrained or lost a row")
        print(f"[ivf] rebuild after a {n_more / N_ROWS:.0%} append ({len(rows_all):,} rows), centroids reused: "
              f"C {grown.bucket_rows.shape[1]}, overflow {int((grown.over_rows >= 0).sum()):,} rows, "
              f"{reuse_s:.3f} s (assignment, quantization and fill)  ({gpu})", flush=True)
        del grown

        for q_count in IVF_QUERY_COUNTS:
            q = queries[:q_count]
            s, ids = ivf_mod.ivf_search(index, rows, q, K)
            err = (s - exact_of(q, ids)).abs().max().item()
            check(bool((ids >= 0).all()) and err <= 1e-6, f"IVF Q={q_count}: a score off the exact path's by {err}")
            check(ordered(s, ids), f"IVF Q={q_count}: not ordered (score desc, row asc)")
            want = exact[q_count][1]
            recall = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / K for a, b in zip(ids, want)]))
            check(recall >= 0.90, f"IVF Q={q_count}: recall@{K} {recall:.4f} under 0.90")
            ms = p50_ms(lambda: ivf_mod.ivf_search(index, rows, q, K), 20)
            report[q_count] = {"ivf_ms": ms, "exact_ms": exact_ms[q_count], "recall": recall, "max_score_err": err}
            print(f"[ivf] Q={q_count} k={K}: p50 {ms:.4f} ms against the exact fused search's "
                  f"{exact_ms[q_count]:.4f} ms on the same rows; recall@{K} {recall:.4f}; scores within "
                  f"{err:.2e} of the exact path's  ({gpu})", flush=True)
        everything = index._replace(nprobe=k_clusters)
        for q_count in (1, 16):
            s, ids = ivf_mod.ivf_search(everything, rows, queries[:q_count], K)
            check(torch.equal(ids, exact[q_count][1]), f"IVF nprobe=K Q={q_count}: ids differ from the exact search")
        print(f"[ivf] nprobe = K = {k_clusters} at Q=1 and 16: ids identical to the exact search", flush=True)
        for q_count in (1, 64):
            trace = device_breakdown(lambda: ivf_mod.ivf_search(index, rows, queries[:q_count], K))
            report[q_count]["trace"] = trace
            print_breakdown("ivf-trace", f"ivf_search Q={q_count} k={K}", trace, gpu)

        # The entry points under --mode ivf on phase 4's database.
        ImageDatabase.generate_html_gallery = lambda self, results, *a, **kw: galleries.append(list(results))
        common = ["-k", str(K), "--db", db, "--model-cache", cache, "--no-session", "--mode", "ivf"]
        run_cli(cli, "search", "a red car", *common)
        run_cli(cli, "search", str(files[7]), "--image", *common)
        ImageDatabase.generate_html_gallery = saved_gallery
        os.environ["TPUCLIP_SEARCH_MODE"] = "ivf"
        engine = ImageDatabase(db, cache, inference_batch_size=64)
        engine.index.refresh()
        check(engine.index._ivf is not None and not engine.index.can_fuse_text_search(K, None),
              "phase 4's database under --mode ivf built no IVF index, or left the fused gate open")
        b64 = base64.b64encode(files[3].read_bytes()).decode()
        srv = SearchServer(engine, host="127.0.0.1", port=0)
        thread = srv.start_background()
        call = functools.partial(http_call, srv, statuses)
        try:
            text = call("/search", {"query": "a yellow taxi", "k": K})
            batch = call("/search_batch", {"queries": TEXTS, "k": K})
            upload = call("/search", {"image_b64": b64, "k": K})
            stats = call("/stats")
        finally:
            srv.shutdown()
            thread.join(timeout=30)
        index_db = engine.index
        same = functools.partial(same_served, engine)
        errs = [same(text["results"], index_db.search_batch(engine.embed_texts(["a yellow taxi"]), K)[0],
                     "ivf text /search")]
        for q, body, want in zip(TEXTS, batch["results"], index_db.search_batch(engine.embed_texts(TEXTS), K)):
            errs.append(same(body, want, f"ivf /search_batch {q!r}", dedup=False))
        pil = load_image_bytes(base64.b64decode(b64), "<bytes>")
        errs.append(same(upload["results"], index_db.search_batch(engine.embed_pils([pil]), K)[0], "ivf image /search"))
        cli_want = [index_db.search_batch(engine.embed_texts(["a red car"]), K)[0],
                    index_db.search(engine._get_image_embedding(str(files[7])), K)]
        check(len(galleries) == 2, f"the two CLI searches handed {len(galleries)} result lists to the gallery")
        for got, want, what in zip(galleries, cli_want, ("search --mode ivf", "search --image --mode ivf")):
            want = filter_duplicates(engine.store, want)
            check([p for p, _ in got] == [p for p, _ in want] and got, f"{what}: paths differ from search_batch")
            errs.append(max(abs(s - w) for (_, s), (_, w) in zip(got, want)))
        check(max(errs) <= 1e-6 and stats["search_mode"] == "ivf" and all(s == 200 for s in statuses),
              f"the IVF entry points: max score diff {max(errs)}, /stats {stats}, statuses {statuses}")
        torch.cuda.synchronize()
        launches = {wrapper.__name__: wrapper.launches for wrapper in COUNTED}
    finally:
        ivf_mod.ivf_topk_rerank = real_rerank
        ImageDatabase.generate_html_gallery = saved_gallery
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    print(f"[ivf] search --mode ivf (text, --image) through tpuclip_torch.cli and serve (text /search, "
          f"4-text /search_batch, image /search; /stats search_mode {stats['search_mode']}) on phase 4's "
          f"{N_IMAGES} rows (K {index_db._ivf.bucket_rows.shape[0]}): equal to DeviceIndex.search_batch under "
          f"IVF, max score diff {max(errs):.2e}", flush=True)
    print(f"[ivf] kernel launches on the IVF path: {launches}; the probe's: {probes[0]}", flush=True)
    check(launches["int8_scores"] == probes[0] > 0, f"kernel 1 launched {launches['int8_scores']} times, "
          f"the probe {probes[0]}")
    check(all(n == 0 for name, n in launches.items() if name != "int8_scores" and name not in TOWER_KERNELS),
          f"a kernel off the IVF path was launched: {launches}")

    # The kernel route against the route through kernel 1's plain version.
    ivf_mod.int8_scores = ops._int8_scores_plain
    try:
        plain = {q_count: ivf_mod.ivf_search(index, rows, queries[:q_count], K) for q_count in (1, 16)}
    finally:
        ivf_mod.int8_scores = ops.int8_scores
    for q_count, (s_p, i_p) in plain.items():
        s, ids = ivf_mod.ivf_search(index, rows, queries[:q_count], K)
        check(torch.equal(ids, i_p) and torch.equal(s, s_p),
              f"IVF Q={q_count}: the kernel route differs from the route through the plain version")
    print("[ivf] Q=1 and 16: the kernel route id- and score-identical to the route through "
          "_int8_scores_plain", flush=True)
    print("[phase12-json] " + json.dumps({
        "gpu": gpu, "k_clusters": k_clusters, "capacity": cap, "nprobe": index.nprobe,
        "overflow_rows": overflow, "ivf_bytes": index.nbytes(), "build_s": build_s, "reuse_s": reuse_s,
        "queries": report, "launches": launches, "probe_launches": probes[0]}), flush=True)
    return launches, {"rows": rows, "queries": queries, "index": index, "exact": exact, "exact_of": exact_of}


# Training at full width (phase 13).
N_TRAIN_PAIRS = 64
TRAIN_STEPS = 5
TRAIN_BATCH = 16
COLOURS = ("red", "green", "blue", "yellow", "purple", "orange", "white", "black")


def write_captioned_jpegs(root, n):
    """``n`` seeded 224 x 224 JPEGs, each with a sidecar caption."""
    from PIL import Image

    rng = np.random.default_rng(13)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        arr = np.clip(rng.integers(0, 256, (1, 1, 3)) + rng.integers(-40, 40, (224, 224, 3)), 0, 255)
        Image.fromarray(arr.astype(np.uint8)).save(root / f"pair_{i:03d}.jpg", quality=90)
        (root / f"pair_{i:03d}.txt").write_text(f"a {COLOURS[i % len(COLOURS)]} photo, number {i}")


def phase_train(gpu, work):
    """Phase 13: ``train`` through tpuclip_torch.cli at SO400M width, with
    AdamW and with ``auto``; then one fixed batch in bf16 against fp32 and
    with the encoder layers checkpointed and not. Returns every counted
    kernel's launches in the phase."""
    import shutil
    from contextlib import nullcontext

    from PIL import Image

    from tpuclip_torch import cli
    from tpuclip_torch.models.configs import DEFAULT_MODEL
    from tpuclip_torch.models.loader import load_model
    from tpuclip_torch.models.siglip import remat_scope
    from tpuclip_torch.ops._counters import COUNTED
    from tpuclip_torch.parallel.training import (
        init_train_state,
        make_optimizer,
        make_train_step,
        sigmoid_contrastive_loss,
    )
    from tpuclip_torch.pipelines import train as train_mod
    from tpuclip_torch.text.tokenizer import load_tokenizer

    data = work / "train_pairs"
    write_captioned_jpegs(data, N_TRAIN_PAIRS)
    cache = str(work / "train_models")  # empty: random weights (TPUCLIP_INIT=random)
    reports, runs = [], {}
    real_train = train_mod.train

    def keep_report(*args, **kwargs):
        reports.append(real_train(*args, **kwargs))
        return reports[-1]

    for wrapper in COUNTED:
        wrapper.launches = 0
    train_mod.train = keep_report
    try:
        for optimizer in ("adamw", "auto"):
            out = work / f"train_{optimizer}"
            torch.cuda.reset_peak_memory_stats()
            # Phases 3 and 12 keep their rows for phase 14: the peak counts above them too.
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            run_cli(cli, "train", str(data), "--output", str(out), "--model-cache", cache,
                    "--steps", str(TRAIN_STEPS), "--batch-size", str(TRAIN_BATCH), "--optimizer", optimizer)
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            r = reports[-1]
            want = "adafactor" if optimizer == "auto" else "adamw"
            check(r is not None and r.optimizer == want and r.final_step == TRAIN_STEPS,
                  f"train --optimizer {optimizer}: ran {r and r.optimizer} to step {r and r.final_step}")
            check(all(np.isfinite(r.losses)) and len(r.losses) == TRAIN_STEPS, f"train losses {r.losses}")
            p50 = statistics.median(r.step_seconds[1:])
            # The model it wrote, through the port's loader (linked into a cache).
            link = work / f"load_{optimizer}"
            (link / DEFAULT_MODEL.replace("/", "--")).parent.mkdir(parents=True, exist_ok=True)
            os.symlink(out / "model", link / DEFAULT_MODEL.replace("/", "--"))
            _, model = load_model(DEFAULT_MODEL, str(link), device="cuda", dtype=torch.bfloat16)
            size = (model.cfg.vision.image_size,) * 2
            pixels = torch.from_numpy(np.stack([np.asarray(Image.open(f).convert("RGB").resize(size))
                                                for f in sorted(data.glob("*.jpg"))[:4]])).cuda()
            with uncounted():  # inference (kernel 9), not training
                emb = model.get_image_features(pixels)
            norm_err = (torch.linalg.vector_norm(emb, dim=1) - 1).abs().max().item()
            check(bool(torch.isfinite(emb).all()) and norm_err <= 1e-5,
                  f"the trained model's embeddings are not unit rows ({norm_err})")
            del model, emb
            runs[optimizer] = {"optimizer": r.optimizer, "losses": r.losses, "step_p50_s": p50,
                               "images_per_s": TRAIN_BATCH / p50, "peak_bytes": peak, "held_bytes": held,
                               "wall_s": wall}
            print(f"[train] train --optimizer {optimizer} ({r.optimizer}): {TRAIN_STEPS} steps of "
                  f"{TRAIN_BATCH} at SO400M (bf16 compute, fp32 parameters, layers checkpointed), step p50 "
                  f"{p50 * 1e3:.1f} ms after step 1 = {TRAIN_BATCH / p50:.1f} images/s; losses "
                  f"{', '.join(f'{x:.6f}' for x in r.losses)}; peak {peak:,} bytes allocated ({peak - held:,} "
                  f"above the {held:,} held before); "
                  f"{wall:.1f} s with model init and the checkpoints; model/ loads, unit rows "
                  f"(max |norm - 1| {norm_err:.1e})  ({gpu})", flush=True)
            shutil.rmtree(out)
            torch.cuda.empty_cache()

        # One fixed batch, the same random weights: bf16 against fp32, and
        # checkpointing on and off.
        _, model = load_model(DEFAULT_MODEL, cache, device="cuda", dtype=torch.float32)
        model.requires_grad_(True)
        pairs = train_mod.find_pairs(str(data))
        tokenizer = load_tokenizer(DEFAULT_MODEL, None, vocab_size=model.cfg.text.vocab_size)
        batches = train_mod._batches(pairs, TRAIN_BATCH, model.cfg.vision.image_size, tokenizer, 1, 0)
        images, ids, mask = next(batches)
        batches.close()
        images, ids, mask = (torch.from_numpy(a).cuda() for a in (images, ids, mask))
        with torch.no_grad(), uncounted():  # no gradient: bf16 attention takes kernel 9
            loss32 = sigmoid_contrastive_loss(model, images, ids, torch.float32, mask).item()
            loss16 = sigmoid_contrastive_loss(model, images, ids, torch.bfloat16, mask).item()
        rel = abs(loss16 - loss32) / abs(loss32)
        check(rel <= 2e-2, f"bf16 loss {loss16} off the fp32 loss {loss32} by {rel:.2e} relative")
        remat = {}
        for on in (True, False):
            model.zero_grad(set_to_none=True)
            torch.cuda.reset_peak_memory_stats()
            with remat_scope(model) if on else nullcontext():
                loss = sigmoid_contrastive_loss(model, images, ids, torch.bfloat16, mask)
            loss.backward()
            gnorm = torch.sqrt(sum((p.grad.float() ** 2).sum() for p in model.parameters())).item()
            torch.cuda.synchronize()
            remat[on] = (loss.item(), gnorm, torch.cuda.max_memory_allocated())
        (l_on, g_on, peak_on), (l_off, g_off, peak_off) = remat[True], remat[False]
        check(abs(l_on - l_off) <= 1e-3 and abs(g_on - g_off) <= 1e-3 * g_off,
              f"checkpointing changed the loss ({l_on} vs {l_off}) or the gradient norm ({g_on} vs {g_off})")
        # Where a train step's time goes: one step of each optimizer on this batch.
        model.zero_grad(set_to_none=True)
        traces = {}
        for factored in (False, True):
            opt = make_optimizer(learning_rate=1e-5, warmup_steps=1, total_steps=10, factored=factored)
            state = init_train_state(model, opt)
            step = make_train_step(opt, compute_dtype=torch.bfloat16)
            name = "adafactor" if factored else "adamw"
            traces[name] = device_breakdown(lambda: step(state, images, ids, mask), runs=2)
            print_breakdown("train-trace", f"one {name} step, batch {TRAIN_BATCH}", traces[name], gpu)
            del state, step
        del model
        torch.cuda.synchronize()
        launches = {wrapper.__name__: wrapper.launches for wrapper in COUNTED}
    finally:
        train_mod.train = real_train
    print(f"[train] one batch of {TRAIN_BATCH}: loss bf16 {loss16:.6f}, fp32 {loss32:.6f} ({rel:.2e} relative); "
          f"layers checkpointed / not: loss {l_on:.6f} / {l_off:.6f}, gradient norm {g_on:.6f} / {g_off:.6f}, "
          f"peak {peak_on:,} / {peak_off:,} bytes  ({gpu})", flush=True)
    print(f"[train] kernel launches in this phase: {launches}", flush=True)
    check(all(n == 0 for n in launches.values()), f"a kernel ran in training: {launches}")
    print("[phase13-json] " + json.dumps({
        "gpu": gpu, "runs": runs, "loss_bf16": loss16, "loss_fp32": loss32, "bf16_rel": rel,
        "remat": {"loss": l_on, "grad_norm": g_on, "peak_bytes": peak_on},
        "no_remat": {"loss": l_off, "grad_norm": g_off, "peak_bytes": peak_off}, "traces": traces,
        "launches": launches}), flush=True)
    return launches


# The mesh (phase 14): four shards of the one card.
MESH_SHARDS = 4
MESH_QUERY_COUNTS = (1, 4, 16, 64)
MESH_WORKER_TIMEOUT_S = 300
DP_LAYERS = 4  # the data-parallel step's depth cut (SO400M width)
DP_BATCH = 16
DP_STEPS = 4


@contextmanager
def uncounted():
    """A block whose kernel launches are not the path's under count (the
    references, the checks, the timing loops): every launch counter is put
    back as it was."""
    from tpuclip_torch.ops._counters import COUNTED

    saved = [w.launches for w in COUNTED]
    try:
        yield
    finally:
        torch.cuda.synchronize()
        for w, n in zip(COUNTED, saved):
            w.launches = n


@contextmanager
def environ(**values):
    """Environment variables set for a block (None: unset), then restored."""
    saved = {key: os.environ.get(key) for key in values}
    try:
        for key, value in values.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def rescore_brute_force(ops, rows, q, k, chunk=512):
    """(score desc, row asc) top-k over every row of the bf16-rounded
    query's fp32 dots with the bf16 rows, summed over (Q, 512, D) blocks as
    the exact rescore sums its 512-row gather, so the two round alike: the
    int8 search's exact answer."""
    qr = ops.round_f32_to_bf16_bits(q.float())
    scores = torch.empty((q.shape[0], rows.shape[0]), device=q.device)
    block = torch.zeros((chunk, rows.shape[1]), dtype=torch.float32, device=q.device)
    for s0 in range(0, rows.shape[0], chunk):
        part = rows[s0 : s0 + chunk]
        block.zero_()
        block[: len(part)] = part.float()
        scores[:, s0 : s0 + len(part)] = (block[None] * qr[:, None, :]).sum(-1)[:, : len(part)]
    idx = torch.arange(rows.shape[0], device=q.device).expand_as(scores)
    return ops._final_merge(scores, idx, k)


def same_ids_up_to_ties(s, i, s_ref, i_ref, tol):
    """Ids identical to the reference's, except where two rows' scores tie
    within ``tol`` in both (fp32 sums in another order may swap them);
    returns the swapped positions' count."""
    diff = (i != i_ref)
    if not bool(diff.any()):
        return 0
    check(bool(((s - s_ref).abs()[diff] <= tol).all()), "ids differ away from a tie")
    return int(diff.sum())


def phase_mesh(mods, gpu, work, db, cache, resident, binary_rows, ivf_ctx):
    """Phase 14: the mesh. Four shards of the one card over phase 3's rows,
    phase 12's IVF index sharded by cluster, ``DeviceIndex(mesh=...)`` in
    every mode on phases 4's and 5's databases, one data-parallel step over
    two replicas, an NCCL group of one process and two processes over
    gloo; returns every counted kernel's launches on the mesh path."""
    import copy
    import dataclasses

    import torch.distributed as dist

    from tpuclip_torch.engine import ImageDatabase
    from tpuclip_torch.index.search import DeviceIndex
    from tpuclip_torch.models.configs import DEFAULT_MODEL, get_config
    from tpuclip_torch.models.siglip import build_model, init_params_, remat_scope
    from tpuclip_torch.ops._counters import COUNTED
    from tpuclip_torch.parallel import sharded_search as sh
    from tpuclip_torch.parallel import training as tr
    from tpuclip_torch.parallel.mesh import DATA_AXIS, make_mesh, maybe_distributed_init
    from tpuclip_torch.parallel.sharded_ivf import shard_ivf, sharded_ivf_search
    from tpuclip_torch.pipelines import train as train_mod
    from tpuclip_torch.text.tokenizer import load_tokenizer

    ops, tops, hops = mods
    rows, m, scales, queries = resident
    dev = rows.device
    mesh4 = make_mesh([dev] * MESH_SHARDS)
    report = {"gpu": gpu, "shards": MESH_SHARDS}
    for wrapper in COUNTED:
        wrapper.launches = 0

    # (a) the 1M rows over four shards: each shard 251,904 rows (the int8
    # tile times 41), the last ones padding.
    rows4, _ = sh.pad_for_mesh(rows, mesh4, ops.INT8_TILE_N)
    m4, sc4 = ops.derive_int8_matrix(rows, len(rows4))
    check(torch.equal(m4[:N_ROWS], m[:N_ROWS]) and torch.equal(sc4[:N_ROWS], scales[:N_ROWS]),
          "the four-shard int8 matrix differs from phase 3's")
    M, SC, R = (sh.shard_matrix(x, mesh4) for x in (m4, sc4, rows4))
    print(f"[mesh] (a) {N_ROWS:,} x {DIM} rows over {MESH_SHARDS} shards of {dev} ({R.rows_per_shard:,} rows "
          f"each, {R.shape[0] - N_ROWS:,} padding rows in the last)", flush=True)
    rerank, cases = {}, []
    for q_count in MESH_QUERY_COUNTS:
        q = queries[:q_count]
        s, i = sh.sharded_topk_int8_rerank(q, M, SC, R, K, mesh4, N_ROWS)
        with uncounted():
            s1, i1 = ops.topk_int8_rerank_fused_auto(q, m, scales, rows, K, n_valid=N_ROWS)
            bs, bi = rescore_brute_force(ops, rows, q, K)
            ms = p50_ms(lambda: sh.sharded_topk_int8_rerank(q, M, SC, R, K, mesh4, N_ROWS), 20)
            ms1 = p50_ms(lambda: ops.topk_int8_rerank_fused_auto(q, m, scales, rows, K, n_valid=N_ROWS), 20)
        err = max((s - s1).abs().max().item(), (s - bs).abs().max().item())
        check(torch.equal(i, i1) and torch.equal(i, bi) and err <= 1e-6,
              f"mesh int8 rerank Q={q_count}: ids differ from the single-device or brute-force search, "
              f"or scores off by {err}")
        rerank[q_count] = (s, i)
        cases.append({"case": f"int8 rerank Q={q_count}", "ms": ms, "single_ms": ms1, "max_err": err})
    for q_count in (1, 16):
        if q_count == 1:  # one query, host-quantized, as DeviceIndex's single search
            qi, qs = ops.quantize_query(queries[:1].cpu().numpy())
            qi = qi.to(dev)
        else:
            qi, qs = ops.quantize_queries(queries[:q_count])
        s, i = sh.sharded_topk_int8(qi, M, SC, qs, 4 * K, mesh4, N_ROWS)
        with uncounted():
            s1, i1 = ops.topk_int8(qi, m, scales, qs, 4 * K, N_ROWS)
            with plain_kernels(mods):
                sp, ip = ops.topk_int8_scores(qi, m, scales, qs, 4 * K, N_ROWS)
            ms = p50_ms(lambda: sh.sharded_topk_int8(qi, M, SC, qs, 4 * K, mesh4, N_ROWS), 20)
            ms1 = p50_ms(lambda: ops.topk_int8(qi, m, scales, qs, 4 * K, N_ROWS), 20)
        err = max((s - s1).abs().max().item(), (s - sp).abs().max().item())
        check(torch.equal(i, i1) and torch.equal(i, ip) and err <= 1e-6,
              f"mesh int8 (kernel 3 a shard) Q={q_count}: ids differ or scores off by {err}")
        cases.append({"case": f"int8 host route Q={q_count} k={4 * K}", "ms": ms, "single_ms": ms1, "max_err": err})
    keep = torch.zeros(len(rows4), device=dev)
    keep[torch.arange(len(rows4), device=dev) % 3 != 0] = float("-inf")
    keep[N_ROWS:] = float("-inf")
    for q_count, mask in ((1, None), (16, None), (1, keep), (16, keep)):
        q = queries[:q_count]
        s, i = sh.sharded_topk(q, R, K, mesh4, N_ROWS, mask=mask)
        single_mask = None if mask is None else mask[:N_ROWS]
        with uncounted():
            s1, i1 = tops.cosine_topk(q, rows, K, N_ROWS, mask=single_mask)
            plain = tops._scores_plain(q, rows, N_ROWS)
            if mask is not None:
                plain = plain + single_mask[None]
            sp, ip = ops._final_merge(plain, torch.arange(N_ROWS, device=dev).expand_as(plain), K)
            ms = p50_ms(lambda: sh.sharded_topk(q, R, K, mesh4, N_ROWS, mask=mask), 10)
            ms1 = p50_ms(lambda: tops.cosine_topk(q, rows, K, N_ROWS, mask=single_mask), 10)
        swaps = same_ids_up_to_ties(s, i, s1, i1, 1e-6)
        err = max((s - s1).abs().max().item(), (s - sp).abs().max().item())
        kth_ok = bool((plain.gather(1, i) >= sp[:, -1:] - 1e-5).all())
        check(err <= 1e-5 and kth_ok and ordered(s, i) and (mask is None or bool((i % 3 == 0).all())),
              f"mesh bf16 Q={q_count} mask={mask is not None}: scores off by {err}, or a row outside the top")
        name = f"bf16 Q={q_count}" + (" folder mask" if mask is not None else "")
        cases.append({"case": name, "ms": ms, "single_ms": ms1, "max_err": err, "tie_swaps": swaps})
    del plain, keep
    words, bq = binary_rows
    blocks, brps, _ = sh.shard_words_grouped(words[:N_BINARY], mesh4)
    for q_count in (1, 4, 16):
        q = bq[:q_count]
        s, i = sh.sharded_binary_topk(q, blocks, K, mesh4, N_BINARY)
        with uncounted():
            s1, i1 = hops.binary_topk(q, words, K, N_BINARY)
            sp, ip = hops._binary_topk_plain(q, words, K, N_BINARY)
            ms = p50_ms(lambda: sh.sharded_binary_topk(q, blocks, K, mesh4, N_BINARY), 10)
            ms1 = p50_ms(lambda: hops.binary_topk(q, words, K, N_BINARY), 10)
        check(torch.equal(s, s1) and torch.equal(i, i1) and torch.equal(s, sp) and torch.equal(i, ip),
              f"mesh binary Q={q_count}: matches or rows differ from the single-device or brute-force search")
        cases.append({"case": f"binary Q={q_count}", "ms": ms, "single_ms": ms1, "max_err": 0})
    m_c = 2 * 640  # the cascade's single-query shortlist at k = 20
    s, i = sh.sharded_binary_shortlist(bq[:1], blocks, m_c, mesh4, N_BINARY, brps)
    with uncounted():
        s1, i1 = hops.binary_shortlist_q1(bq[:1], words, m_c, N_BINARY)
        ms = p50_ms(lambda: sh.sharded_binary_shortlist(bq[:1], blocks, m_c, mesh4, N_BINARY, brps), 10)
        ms1 = p50_ms(lambda: hops.binary_shortlist_q1(bq[:1], words, m_c, N_BINARY), 10)
    check(torch.equal(s, s1) and torch.equal(i, i1), "mesh cascade shortlist differs from the single-device one")
    cases.append({"case": f"cascade shortlist m={m_c}", "ms": ms, "single_ms": ms1, "max_err": 0})
    with uncounted():
        traces = {q_count: device_breakdown(lambda: sh.sharded_topk_int8_rerank(
            queries[:q_count], M, SC, R, K, mesh4, N_ROWS)) for q_count in (1, 64)}
    for q_count, trace in traces.items():
        print_breakdown("mesh-trace", f"int8 rerank over {MESH_SHARDS} shards Q={q_count} k={K}", trace, gpu)
    report["a_trace"] = traces
    for c in cases:
        print(f"[mesh] (a) {c['case']}: equal to the single-device search and the brute force "
              f"(max diff {c['max_err']:.2e}{', %d tie swaps' % c['tie_swaps'] if c.get('tie_swaps') else ''}); "
              f"p50 {c['ms']:.4f} ms over {MESH_SHARDS} shards vs {c['single_ms']:.4f} ms on one  ({gpu})",
              flush=True)
    report["a"] = cases

    # (e) first half: an NCCL group of one process; its cross-process merge
    # gives (a)'s results.
    with environ(TPUCLIP_MULTIHOST="1", JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}",
                 JAX_NUM_PROCESSES="1", JAX_PROCESS_ID="0"):
        maybe_distributed_init()
        try:
            backend = "nccl" if dev.type == "cuda" else "gloo"
            check(dist.get_backend() == backend and dist.get_world_size() == 1, "maybe_distributed_init: no NCCL group")
            group_mesh = make_mesh([dev] * MESH_SHARDS)
            check(group_mesh.group is not None and group_mesh.shape[DATA_AXIS] == MESH_SHARDS,
                  f"the mesh did not join the group: {group_mesh}")
            for q_count in MESH_QUERY_COUNTS:
                s, i = sh.sharded_topk_int8_rerank(queries[:q_count], M, SC, R, K, group_mesh, N_ROWS)
                check(torch.equal(i, rerank[q_count][1]) and torch.equal(s, rerank[q_count][0]),
                      f"NCCL world 1 Q={q_count}: the merge through the group differs from (a)'s")
        finally:
            dist.destroy_process_group()
    print(f"[mesh] (e) NCCL group of one process (maybe_distributed_init, TPUCLIP_MULTIHOST=1): the int8 "
          f"rerank at Q={', '.join(map(str, MESH_QUERY_COUNTS))} through all_gather equals (a)'s", flush=True)
    del M, SC, R, rows4, m4, sc4, blocks
    torch.cuda.empty_cache()

    # (b) phase 12's IVF index (K = 2,000, its centroids) sharded by cluster.
    rows_i, q_i, index = ivf_ctx["rows"], ivf_ctx["queries"], ivf_ctx["index"]
    k_clusters = index.centroids.shape[0]
    t0 = time.perf_counter()
    sivf = shard_ivf(index, rows_i, mesh4)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    for q_count in (1, 16):
        s, i = sharded_ivf_search(sivf, q_i[:q_count], K, nprobe=k_clusters)
        want_s, want_i = ivf_ctx["exact"][q_count]
        err = (s - want_s).abs().max().item()
        check(torch.equal(i, want_i) and err <= 1e-6,
              f"sharded IVF nprobe=K Q={q_count}: ids differ from the exact search, or scores by {err}")
    ivf_report = {"bytes": sivf.nbytes(), "shard_s": shard_s, "k_clusters": k_clusters, "nprobe": sivf.nprobe}
    for q_count in (1, 64):
        q = q_i[:q_count]
        s, i = sharded_ivf_search(sivf, q, K)
        err = (s - ivf_ctx["exact_of"](q, i)).abs().max().item()
        want = ivf_ctx["exact"][q_count][1]
        recall = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / K for a, b in zip(i, want)]))
        check(err <= 1e-6 and recall >= 0.90 and ordered(s, i),
              f"sharded IVF Q={q_count}: recall@{K} {recall:.4f}, scores off the exact path's by {err}")
        with uncounted():
            ms = p50_ms(lambda: sharded_ivf_search(sivf, q, K), 10)
        ivf_report[q_count] = {"ms": ms, "recall": recall, "max_score_err": err}
        print(f"[mesh] (b) sharded IVF Q={q_count} k={K} (nprobe {sivf.nprobe}: {-(-sivf.nprobe // MESH_SHARDS)} "
              f"buckets a shard): p50 {ms:.4f} ms, recall@{K} {recall:.4f} against the exact search, scores "
              f"within {err:.2e} of the exact path's  ({gpu})", flush=True)
    print(f"[mesh] (b) K={k_clusters} over {MESH_SHARDS} shards, embedded bf16 rows: {ivf_report['bytes']:,} bytes "
          f"on the card, resharded in {shard_s:.3f} s; nprobe = K at Q=1 and 16: ids identical to the exact "
          f"search  ({gpu})", flush=True)
    report["b"] = ivf_report
    del sivf
    torch.cuda.empty_cache()

    # (c) DeviceIndex(mesh=...) on phase 4's database (and phase 5's
    # binary-only one), through search_batch and the engine.
    bin_db = str(work / "binary.db")
    engines = {path: ImageDatabase(path, cache, inference_batch_size=64) for path in (db, bin_db)}
    q_vecs = engines[db].embed_texts(TEXTS)
    modes = (("int8", {}, db), ("bf16", {"TPUCLIP_SEARCH_PRECISION": "bf16"}, db), ("binary-only", {}, bin_db),
             ("cascade", {"TPUCLIP_SEARCH_MODE": "cascade"}, db), ("ivf", {"TPUCLIP_SEARCH_MODE": "ivf", "TPUCLIP_DEVICE_RERANK": "1"}, db))
    index_report = {}
    for name, env, path in modes:
        values = {"TPUCLIP_SEARCH_PRECISION": "int8", "TPUCLIP_SEARCH_MODE": "exact", "TPUCLIP_DEVICE_RERANK": None,
                  "TPUCLIP_SHARDED_INDEX": None, **env}
        engine = engines[path]
        with environ(**values):
            single, meshed = DeviceIndex(engine.store, device=dev), DeviceIndex(engine.store, mesh=mesh4)
            with uncounted():
                single.refresh()
            meshed.refresh()
            if name == "ivf":
                check(single._ivf is not None and meshed._ivf_sharded is not None, "ivf mode built no IVF index")
                # Both builds are approximate (the device build's torch.Generator start,
                # the host build's numpy one): probe every bucket.
                single._ivf = single._ivf._replace(nprobe=single._ivf.centroids.shape[0])
                meshed._ivf_sharded = meshed._ivf_sharded._replace(nprobe=meshed._ivf_sharded.k_real)
            with uncounted():
                want_batch = single.search_batch(q_vecs, K)
                engine.index = single
                want_engine = engine.search_texts(TEXTS, K)
            got_batch = meshed.search_batch(q_vecs, K)
            engine.index = meshed
            got_engine = engine.search_texts(TEXTS, K)
            check(not meshed.can_fuse_text_search(K, None), "the fused gate is open under a mesh")
            errs = [0.0]
            tol = 1e-5 if name == "bf16" else 1e-6
            for got, want in zip(got_batch + got_engine, want_batch + want_engine):
                check(got and [p for p, _ in got] == [p for p, _ in want],
                      f"DeviceIndex(mesh) {name}: paths differ from the unsharded index's")
                errs.append(max(abs(a - b) for (_, a), (_, b) in zip(got, want)))
            check(max(errs) <= tol, f"DeviceIndex(mesh) {name}: scores off the unsharded index's by {max(errs)}")
            index_report[name] = {"max_err": max(errs), "resident_bytes": meshed.resident_bytes(),
                                  "single_resident_bytes": single.resident_bytes()}
            print(f"[mesh] (c) DeviceIndex(mesh) {name} on {Path(path).name} ({meshed.num_full or meshed.num_binary} "
                  f"rows): search_batch and the engine's search_texts equal to the unsharded index's (max diff "
                  f"{max(errs):.2e}); resident {meshed.resident_bytes():,} bytes over {MESH_SHARDS} shards "
                  f"(unsharded {single.resident_bytes():,})", flush=True)
    with environ(TPUCLIP_SHARDED_INDEX="1", TPUCLIP_SEARCH_PRECISION="int8", TPUCLIP_SEARCH_MODE="exact"), uncounted():
        auto = DeviceIndex(engines[db].store, device=dev)
        got = auto.search_batch(q_vecs, K)
        want = DeviceIndex(engines[db].store, device=dev).search_batch(q_vecs, K)
        check(auto.mesh is None and all([p for p, _ in a] == [p for p, _ in b] for a, b in zip(got, want)),
              f"TPUCLIP_SHARDED_INDEX=1 on {torch.cuda.device_count()} card(s) built a mesh or changed results")
    print(f"[mesh] (c) TPUCLIP_SHARDED_INDEX=1 with {torch.cuda.device_count()} card: no mesh, the single-device "
          f"route, the same results", flush=True)
    report["c"] = index_report
    del engines, auto
    torch.cuda.empty_cache()

    # (d) one data-parallel step over two replicas on the card, SO400M width
    # at a cut depth, batch 16, AdamW.
    full = get_config(DEFAULT_MODEL)
    cfg = dataclasses.replace(full, vision=dataclasses.replace(full.vision, num_layers=DP_LAYERS),
                              text=dataclasses.replace(full.text, num_layers=DP_LAYERS))
    base = init_params_(build_model(cfg, dev, torch.float32), torch.Generator(device=dev).manual_seed(14))
    tokenizer = load_tokenizer(DEFAULT_MODEL, None, vocab_size=cfg.text.vocab_size)
    batches = train_mod._batches(train_mod.find_pairs(str(work / "train_pairs")), DP_BATCH,
                                 cfg.vision.image_size, tokenizer, 1, 0)
    images, ids, mask = (torch.from_numpy(a).to(dev) for a in next(batches))
    batches.close()
    single = copy.deepcopy(base).requires_grad_(True)
    with remat_scope(single):
        loss_g = tr.sigmoid_contrastive_loss(single, images, ids, torch.bfloat16, mask)
    loss_g.backward()
    grads_s = {n: p.grad for n, p in single.named_parameters()}
    opt = tr.make_optimizer(learning_rate=1e-5)
    state_s = tr.init_train_state(copy.deepcopy(base), opt)
    state_s, loss_s = tr.make_train_step(opt, torch.bfloat16)(state_s, images, ids, mask)
    params_s = {n: p.detach().clone() for n, p in state_s.model.named_parameters()}
    del state_s
    mesh2 = make_mesh([dev, dev])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # earlier phases' tensors and this phase's references
    opt_d = tr.make_optimizer(learning_rate=1e-5)
    state_d = tr.init_train_state(copy.deepcopy(base), opt_d, mesh=mesh2)
    loss_dg, grads_d = tr.data_parallel_value_and_grad(state_d, mesh2, images, ids, mask, torch.bfloat16)
    num = sum(float(((grads_d[n] - g) ** 2).sum()) for n, g in grads_s.items())
    den = sum(float((g ** 2).sum()) for g in grads_s.values())
    grad_rel = (num / den) ** 0.5
    del grads_d, grads_s, single
    step_d = tr.make_train_step(opt_d, torch.bfloat16, mesh=mesh2)
    times, losses = [], []
    for _ in range(DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state_d, loss_d = step_d(state_d, images, ids, mask)
        losses.append(loss_d.item())
        times.append(time.perf_counter() - t0)
        if len(losses) == 1:
            param_rel = (sum(float((p - params_s[n]).pow(2).sum()) for n, p in state_d.model.named_parameters())
                         / sum(float(p.pow(2).sum()) for p in params_s.values())) ** 0.5
            upd = sum(float(((p - base.get_parameter(n)) - (params_s[n] - base.get_parameter(n))).pow(2).sum())
                      for n, p in state_d.model.named_parameters())
            upd_den = sum(float((params_s[n] - base.get_parameter(n)).pow(2).sum()) for n in params_s)
            replicas_equal = all(torch.equal(p, state_d.model.get_parameter(n))
                                 for n, p in state_d.replicas[1].named_parameters())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    loss_rel = abs(losses[0] - loss_s.item()) / abs(loss_s.item())
    step_p50 = statistics.median(times[1:])
    check(loss_rel <= 2e-2 and abs(loss_dg.item() - loss_g.item()) <= 2e-2 * abs(loss_g.item()),
          f"data-parallel loss {losses[0]} off the single-device step's {loss_s.item()} by {loss_rel:.2e}")
    check(grad_rel <= 2e-2 and param_rel <= 2e-2 and replicas_equal and all(np.isfinite(losses)),
          f"data-parallel gradients {grad_rel:.2e} or parameters {param_rel:.2e} off the single-device step's, "
          f"or the replicas differ ({replicas_equal})")
    report["d"] = {"layers": DP_LAYERS, "batch": DP_BATCH, "replicas": 2, "loss_single": loss_s.item(),
                   "losses": losses, "loss_rel": loss_rel, "grad_rel": grad_rel, "param_rel": param_rel,
                   "update_rel": (upd / upd_den) ** 0.5, "step_p50_s": step_p50, "peak_bytes": peak,
                   "held_bytes": held}
    print(f"[mesh] (d) data-parallel step, SO400M width ({cfg.vision.hidden_size} hidden, {cfg.vision.num_heads} "
          f"heads, MLP {cfg.vision.intermediate_size}), {DP_LAYERS} layers a tower, batch {DP_BATCH} over 2 replicas "
          f"of {dev}, AdamW, bf16: first loss {losses[0]:.6f} vs one device {loss_s.item():.6f} ({loss_rel:.2e} "
          f"relative); summed gradients {grad_rel:.2e} relative off one device's; parameters after the step "
          f"{param_rel:.2e} relative off one device's (the update itself {report['d']['update_rel']:.2e}: AdamW's "
          f"first step is ~lr x sign(g), so bf16 noise flips near-zero gradients); replicas equal; losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}; step p50 {step_p50 * 1e3:.1f} ms after step 1; peak "
          f"{peak:,} bytes allocated by the replicas and the steps (over {held:,} held before)  ({gpu})", flush=True)
    del state_d, base, params_s
    torch.cuda.empty_cache()

    # (e) second half: two processes over gloo, two shards of the card
    # each: four global shards over the 1M rows.
    port = free_port()
    outs = [work / f"mesh_worker_{r}.json" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--mesh-worker", str(r), str(port),
                               str(outs[r])], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    t0 = time.perf_counter()
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=MESH_WORKER_TIMEOUT_S)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    workers_s = time.perf_counter() - t0
    for r, (proc, log) in enumerate(zip(procs, logs)):
        check(proc.returncode == 0, f"mesh worker {r} exited {proc.returncode}\n{log[-3000:]}")
    for r in range(2):
        got = json.loads(outs[r].read_text())
        for q_count in MESH_QUERY_COUNTS:
            s, i = rerank[q_count]
            check(got[str(q_count)]["ids"] == i.cpu().tolist()
                  and np.abs(np.array(got[str(q_count)]["scores"]) - s.cpu().numpy()).max() <= 1e-6,
                  f"gloo worker {r} Q={q_count}: ids differ from (a)'s")
    print(f"[mesh] (e) 2 processes over gloo (TPUCLIP_MULTIHOST=1, JAX_* coordinator variables), 2 shards of {dev} "
          f"each = {MESH_SHARDS} global shards: int8 rerank ids at Q={', '.join(map(str, MESH_QUERY_COUNTS))} "
          f"identical to (a)'s, in {workers_s:.1f} s with their start-up", flush=True)
    report["e"] = {"nccl_world_1": True, "gloo_workers_s": workers_s}

    torch.cuda.synchronize()
    launches = {wrapper.__name__: wrapper.launches for wrapper in COUNTED}
    print(f"[mesh] kernel launches on the mesh path: {launches}", flush=True)
    idle = ("patch_embed_fused", "attention_sm90", "silu_mul", "rope")  # no kernel 8, Hopper shape, SwiGLU or RoPE
    check(all(n > 0 for name, n in launches.items() if name not in idle),
          f"a kernel of the mesh path was not launched: {launches}")
    check(launches["patch_embed_fused"] == 0, f"kernel 8 ran on the mesh path: {launches}")
    report["launches"] = launches
    print("[phase14-json] " + json.dumps(report), flush=True)
    return launches


def mesh_worker(rank, port, out):
    """One of phase 14's two gloo processes: two shards of the card, joined
    by ``maybe_distributed_init`` into four global shards over phase 3's
    rows; writes its int8 rerank results at each query count to ``out``."""
    import torch.distributed as dist

    from tpuclip_torch.ops import topk_int8 as ops
    from tpuclip_torch.parallel import sharded_search as sh
    from tpuclip_torch.parallel.mesh import DATA_AXIS, make_mesh, maybe_distributed_init

    os.environ.update(TPUCLIP_MULTIHOST="1", JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                      JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank))
    maybe_distributed_init(backend="gloo", timeout_s=MESH_WORKER_TIMEOUT_S)
    try:
        dev = torch.device("cuda", 0)
        mesh = make_mesh([dev, dev])
        check(mesh.shape[DATA_AXIS] == MESH_SHARDS and mesh.rank == rank, f"worker mesh {mesh}")
        rows, queries = main_rows(dev)
        rows4, _ = sh.pad_for_mesh(rows, mesh, ops.INT8_TILE_N)
        m4, sc4 = ops.derive_int8_matrix(rows, len(rows4))
        del rows
        M, SC, R = (sh.shard_matrix(x, mesh) for x in (m4, sc4, rows4))
        result = {}
        for q_count in MESH_QUERY_COUNTS:
            s, i = sh.sharded_topk_int8_rerank(queries[:q_count], M, SC, R, K, mesh, N_ROWS)
            result[q_count] = {"ids": i.cpu().tolist(), "scores": s.cpu().tolist()}
        Path(out).write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()
    return 0


# The shortlist methods (phase 15): TPUCLIP_SHORTLIST=approx / verified.
SHORTLIST_QUERIES = 256
SHORTLIST_METHODS = ("exact", "extract", "approx", "verified")


def exact_row_scores(ops, rows, q, ids):
    """The exact rescore's score of each returned row (bf16 rows, the
    bf16-rounded query, fp32 products summed over D): (Q, k) f32, -inf
    where a slot holds no row."""
    qr = ops.round_f32_to_bf16_bits(q.float())
    valid = ids < rows.shape[0]
    got = (rows[ids.clamp(max=rows.shape[0] - 1)].float() * qr[:, None, :]).sum(-1)
    return got.masked_fill(~valid, float("-inf"))


def int8_rank(scores, row):
    """Rank of ``row`` in one query's (N,) int8 scores, ordered (score desc,
    row asc)."""
    s = scores[row]
    return int((scores > s).sum()) + int((scores[:row] == s).sum())


def phase_shortlist(mods, gpu, resident, engine):
    """Phase 15: the ``approx`` and ``verified`` shortlists at SO400M width
    over phase 3's 1M rows and through the entry points; returns every
    counted kernel's launches in the phase (its checks and timing loops
    excluded)."""
    from tpuclip_torch.ops._counters import COUNTED
    from tpuclip_torch.ops.graphs import FusedGraphs
    from tpuclip_torch.serve import SearchServer

    ops = mods[0]
    rows, m, scales = resident[:3]
    dev, n_pad = rows.device, m.shape[0]
    depth = min(max(512, 4 * K), n_pad)
    verify_j = min(depth, max(64, 4 * K))
    bins, fold = ops.approx_reduction_size(n_pad, depth, ops.APPROX_RECALL)
    print(f"[shortlist] {N_ROWS:,} rows padded to {n_pad:,}: the approximate top-{depth} folds them into "
          f"L = {bins:,} bins of {1 << fold} (recall target {ops.APPROX_RECALL}); verified proves the top "
          f"J = {verify_j}  ({gpu})", flush=True)
    check(bins == 15_744, f"L = {bins}, expected 15,744 (XLA's bin count at 1,001,472 rows, top-512, 0.95)")
    rng = np.random.default_rng(15)
    queries = torch.from_numpy(rng.standard_normal((SHORTLIST_QUERIES, DIM), dtype=np.float32)).to(dev)
    queries /= torch.linalg.vector_norm(queries, dim=1, keepdim=True)
    for wrapper in COUNTED:
        wrapper.launches = 0

    # (a) 256 single queries under exact, approx and verified (the auto
    # wrapper with its fallback), then batches under extract and approx.
    single, stats = {}, {}
    for method in ("exact", "approx", "verified"):
        with environ(TPUCLIP_SHORTLIST=method):
            out = [ops.topk_int8_rerank_fused_auto(q[None], m, scales, rows, K, n_valid=N_ROWS, stats=stats)
                   for q in queries]
        single[method] = (torch.cat([s for s, _ in out]), torch.cat([i for _, i in out]))
    batches = {}
    for q_count in (4, 16, 64):
        for method in ("extract", "approx"):
            with environ(TPUCLIP_SHORTLIST=method):
                batches[method, q_count] = ops.topk_int8_rerank_fused_auto(
                    queries[:q_count], m, scales, rows, K, n_valid=N_ROWS, stats=stats)
    torch.cuda.synchronize()
    fallbacks = stats["shortlist_fallbacks"]
    check(stats["verified_queries"] == SHORTLIST_QUERIES and stats["exact_searches"] == SHORTLIST_QUERIES,
          f"the auto wrapper's counts {stats}")
    with uncounted():
        s_ex, i_ex = single["exact"]
        passes, differing, outside_j = 0, 0, 0
        for qi_, q in enumerate(queries):
            q_int8, _ = ops.quantize_queries(q[None])
            scores = ops.int8_scores(q_int8, m, scales, N_ROWS)
            _, cand, ok = ops._verified_shortlist(scores, depth, verify_j, ops.APPROX_RECALL)
            if bool(ok):
                passes += 1
                top_j = ops._final_merge(scores, torch.arange(n_pad, device=dev)[None], verify_j)[1]
                check(bool(torch.isin(top_j, cand).all()),
                      f"query {qi_}: a shortlist that passed its proof misses the exact int8 top-{verify_j}")
            got, want = single["verified"][1][qi_].tolist(), i_ex[qi_].tolist()
            if got != want:
                differing += 1
                check(bool(ok), f"query {qi_}: the fallback's ids differ from exact's")
                for row in set(want) - set(got):
                    rank = int8_rank(scores[0], row)
                    check(rank >= verify_j, f"query {qi_}: row {row} (int8 rank {rank}) missing, above J")
                    outside_j += 1
        check(SHORTLIST_QUERIES - passes == fallbacks,
              f"{SHORTLIST_QUERIES - passes} proofs failed but {fallbacks} fallbacks were counted")
        recall = {}
        for method, (s, i) in single.items():
            err = float((s - exact_row_scores(ops, rows, queries, i)).abs().max())
            check(err <= 1e-6 and bool(torch.isfinite(s).all()) and tuple(s.shape) == (SHORTLIST_QUERIES, K),
                  f"{method}: scores off the rows' exact scores by {err}, or shape {tuple(s.shape)}")
            recall[method] = float(np.mean([len(set(a) & set(b)) / K for a, b in zip(i.tolist(), i_ex.tolist())]))
        batch_recall = {}
        for (method, q_count), (s, i) in batches.items():
            q = queries[:q_count]
            want = ops.topk_int8_rerank_fused(q, m, scales, rows, K, n_valid=N_ROWS, shortlist_method="exact")[1]
            err = float((s - exact_row_scores(ops, rows, q, i)).abs().max())
            check(err <= 1e-6 and bool(torch.isfinite(s).all()) and tuple(s.shape) == (q_count, K),
                  f"{method} at Q = {q_count}: scores off by {err}, or shape {tuple(s.shape)}")
            batch_recall[f"{method}_q{q_count}"] = float(
                np.mean([len(set(a) & set(b)) / K for a, b in zip(i.tolist(), want.tolist())]))
    print(f"[shortlist] (a) {SHORTLIST_QUERIES} single queries: verified passed its proof {passes} times "
          f"({passes / SHORTLIST_QUERIES:.1%}), {fallbacks} fallbacks over the resident scores; every "
          f"passed shortlist holds the exact int8 top-{verify_j}; verified's ids differ from exact's in "
          f"{differing} queries, by {outside_j} rows, each ranked below J in the int8 scores; every "
          f"score within 1e-6 of its row's exact score; recall@{K} against exact: "
          + ", ".join(f"{k} {v:.4f}" for k, v in recall.items()) + "; batches: "
          + ", ".join(f"{k} {v:.4f}" for k, v in batch_recall.items()) + f"  ({gpu})", flush=True)

    # (b) The planted bin collision: "a red car"'s text embedding in rows j
    # and j + L, which share bin j. Phase 3's rows are put back after.
    j = 1234
    planted = [j, j + bins]
    saved = rows[planted].clone(), m[planted].clone(), scales[planted].clone()
    try:
        emb = torch.from_numpy(engine.embed_texts(["a red car"])).to(dev)
        rows[planted] = emb.to(rows.dtype)
        m[planted], scales[planted] = ops.derive_int8_matrix(rows[planted], 2)
        before = dict(stats)
        with environ(TPUCLIP_SHORTLIST="approx"):
            approx_ids = ops.topk_int8_rerank_fused_auto(emb, m, scales, rows, K, n_valid=N_ROWS)[1][0].tolist()
        with environ(TPUCLIP_SHORTLIST="verified"):
            s_v, i_v = ops.topk_int8_rerank_fused_auto(emb, m, scales, rows, K, n_valid=N_ROWS, stats=stats)
        with uncounted():
            s_e, i_e = ops.topk_int8_rerank_fused(emb, m, scales, rows, K, n_valid=N_ROWS, shortlist_method="exact")
        check(i_e[0, :2].tolist() == planted and j in approx_ids and j + bins not in approx_ids,
              f"the planted rows: exact's top {i_e[0, :3].tolist()}, approx's {approx_ids[:3]}")
        check(torch.equal(i_v, i_e) and torch.equal(s_v, s_e), "the forced fallback differs from exact")
        check(stats["shortlist_fallbacks"] == before["shortlist_fallbacks"] + 1
              and stats["verified_queries"] == before["verified_queries"] + 1,
              f"the forced fallback's counts: {before} -> {stats}")
    finally:
        rows[planted], m[planted], scales[planted] = saved
    print(f"[shortlist] (b) rows {planted} = the embedding of 'a red car' (one bin): approx keeps row {j} "
          f"and drops {j + bins}; verified fails its proof, falls back once over the resident scores, and "
          f"equals exact's ids and scores", flush=True)

    # (c) The fused text graph at buckets 1 and 16 under verified, as the
    # index runs it (one resident scores buffer, the fallback's tail under
    # the runner's lock), against eager.
    model = engine.model
    texts = [f"{TEXTS[i % len(TEXTS)]}, photo {i}" for i in range(16)]
    tail = (m, scales, rows, K, N_ROWS)
    graphs = FusedGraphs(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    buf = torch.empty((16, n_pad), dtype=torch.float32, device=dev)
    kept = {}

    def verified_tail(outputs):
        s, r, ok, scores, emb = outputs
        s_f, r_f = ops.topk_exact_from_scores(scores, emb, rows, K, ops.fallback_shortlist_depth(K, n_pad))
        kept["fallback"] = s_f.cpu().numpy(), r_f.cpu().numpy()
        return s.cpu().numpy(), r.cpu().numpy(), bool(ok)

    for b in (1, 16):
        host = list(engine._tokenize_bucketed(texts[:b]))

        def program(i, a, b=b):
            return ops.query_topk_fused(model, (i, a), (), *tail, shortlist_method="verified", keep_scores=True,
                                        scores_out=buf[:b])

        s_g, r_g, ok_g = graphs.run(("text", b, "verified"), program, host, verified_tail)
        inputs = [torch.from_numpy(x).to(dev) for x in host]
        with uncounted():
            s_e, r_e, ok_e = ops.query_topk_fused(model, inputs, (), *tail, shortlist_method="verified")
            exact = ops.query_topk_fused(model, inputs, (), *tail, shortlist_method="exact")
        check(np.array_equal(s_g, s_e.cpu().numpy()) and np.array_equal(r_g, r_e.cpu().numpy())
              and ok_g == bool(ok_e), f"verified text graph at bucket {b} is not bit-equal to eager")
        check(all(np.array_equal(x, y.cpu().numpy()) for x, y in zip(kept["fallback"], exact)),
              f"bucket {b}: the fallback over the graph's buffers differs from the exact program")
        print(f"[shortlist] (c) verified text graph at bucket {b}: bit-equal to eager (ok {ok_g}); the "
              f"fallback over its resident scores and embedding equals the exact program", flush=True)
    pool_bytes = graphs.pool_bytes()
    torch.cuda.empty_cache()
    print(f"[shortlist] (c) 2 graphs, one {buf.numel() * 4:,}-byte scores buffer; their pool holds "
          f"{pool_bytes:,} bytes (reserved memory grew by {torch.cuda.memory_reserved() - reserved0:,})  "
          f"({gpu})", flush=True)

    # (d) serve under TPUCLIP_SHORTLIST=verified on phase 4's database.
    check(engine.index.can_fuse_text_search(K, None), "phase 4's index cannot fuse")
    statuses = []
    with environ(TPUCLIP_SHORTLIST="verified"):
        srv = SearchServer(engine, host="127.0.0.1", port=0)
        thread = srv.start_background()
        try:
            first = http_call(srv, statuses, "/stats")
            for i in range(20):
                body = http_call(srv, statuses, "/search", {"query": f"a verified photo {i}", "k": K})
                check(len(body["results"]) > 0, "a verified /search returned no results")
                if i == 0:
                    with environ(TPUCLIP_SHORTLIST="exact"), uncounted():
                        want = engine.search_texts([f"a verified photo {i}"], K)[0]
                    same_served(engine, body["results"], want, "verified /search")
            last = http_call(srv, statuses, "/stats")
        finally:
            srv.shutdown()
            thread.join(timeout=30)
    check(not thread.is_alive(), "the server did not shut down")
    keys = ("verified_queries", "shortlist_fallbacks")
    check(all(k in first and k in last for k in keys) and last["verified_queries"] - first["verified_queries"] == 20,
          f"/stats: {[(k, first.get(k), last.get(k)) for k in keys]}")
    check(all(code == 200 for code in statuses), f"statuses other than 200: {statuses}")
    print(f"[shortlist] (d) serve under verified: 20 sequential text /search, all 200; /stats "
          f"verified_queries {first['verified_queries']} -> {last['verified_queries']}, shortlist_fallbacks "
          f"{first['shortlist_fallbacks']} -> {last['shortlist_fallbacks']}  ({gpu})", flush=True)
    torch.cuda.synchronize()
    launches = {wrapper.__name__: wrapper.launches for wrapper in COUNTED}
    print(f"[shortlist] kernel launches in this phase: {launches}", flush=True)
    check(launches["int8_scores"] > 0 and launches["int8_candidates_packed"] > 0,
          f"kernels 1 and 2 must launch in this phase: {launches}")

    # (e) Device p50s (CUDA events) of the fused search per method, of the
    # bucket-1 text graph per method, and where the single query's time goes.
    timings = {"search": {}, "graph_q1": {}, "wall_q1": {}}
    with uncounted():
        for q_count in (1, 16, 64):
            q = queries[:q_count]
            for method in SHORTLIST_METHODS:
                timings["search"][f"{method}_q{q_count}"] = p50_ms(lambda: ops.topk_int8_rerank_fused(
                    q, m, scales, rows, K, n_valid=N_ROWS, shortlist_method=method), 20)
        host = list(engine._tokenize_bucketed(texts[:1]))
        for method in SHORTLIST_METHODS:
            key = ("text", 1, method, "timed")
            verified = method == "verified"
            graphs.run(key, lambda i, a, method=method, verified=verified: ops.query_topk_fused(
                model, (i, a), (), *tail, shortlist_method=method, keep_scores=verified,
                scores_out=buf[:1] if verified else None), host, lambda outs: None)
            timings["graph_q1"][method] = p50_ms(graphs._graphs[key].graph.replay, 20)
        q1 = queries[:1]
        for method in ("exact", "verified"):
            with environ(TPUCLIP_SHORTLIST=method):
                timings["wall_q1"][method] = wall_p50_ms(lambda: ops.topk_int8_rerank_fused_auto(
                    q1, m, scales, rows, K, n_valid=N_ROWS)[1].cpu(), 50)
        traces = {method: device_breakdown(lambda method=method: ops.topk_int8_rerank_fused(
            q1, m, scales, rows, K, n_valid=N_ROWS, shortlist_method=method)) for method in ("exact", "verified")}
    for q_count in (1, 16, 64):
        print(f"[shortlist] (e) fused search at Q = {q_count}, device p50 ms: " + ", ".join(
            f"{method} {timings['search'][f'{method}_q{q_count}']:.4f}" for method in SHORTLIST_METHODS)
            + f"  ({gpu})", flush=True)
    print("[shortlist] (e) text graph at bucket 1, device p50 ms: " + ", ".join(
        f"{method} {ms:.4f}" for method, ms in timings["graph_q1"].items()) + f"  ({gpu})", flush=True)
    print("[shortlist] (e) auto wrapper at Q = 1, host-to-host p50 ms: " + ", ".join(
        f"{method} {ms:.4f}" for method, ms in timings["wall_q1"].items()) + f"  ({gpu})", flush=True)
    for method, trace in traces.items():
        print_breakdown("shortlist-trace", f"fused search at Q = 1, {method}", trace, gpu)
    print("[phase15-json] " + json.dumps({
        "gpu": gpu, "bins": bins, "fold": 1 << fold, "verify_depth": verify_j, "queries": SHORTLIST_QUERIES,
        "proof_passes": passes, "fallbacks": fallbacks, "verified_differing_queries": differing,
        "recall_at_k": recall, "batch_recall_at_k": batch_recall, "pool_bytes": pool_bytes,
        "p50_ms": timings, "trace": {k: {"wall_ms": t[0], "busy_ms": t[1], "launches": t[2], "top": t[3]}
                                     for k, t in traces.items()},
        "launches": launches}), flush=True)
    del graphs, buf
    return launches


# Tensor-parallel towers (phase 16): the card named several times as a
# (data, model) mesh.
TP_MESHES = ((1, 2), (2, 2), (1, 4))
TP_IMAGES = 64
TP_NAFLEX = 16
TP_STEPS = 3
TP_REPS = 5


def cosines(a, b):
    """Each row's cosine between two (B, D) feature sets, in float64."""
    a, b = a.double(), b.double()
    return (a * b).sum(-1) / (torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1))


def per_row(replicas, fn, *inputs):
    """Each replica's features of its rows of ``inputs``, concatenated."""
    b = inputs[0].shape[0] // len(replicas)
    return torch.cat([fn(r, *(x[j * b : (j + 1) * b] for x in inputs)) for j, r in enumerate(replicas)])


def split_over(replica, mp):
    """Every encoder layer's and the vision head's attention and MLP are
    split over ``mp`` ranks: no block runs the one-device module."""
    from tpuclip_torch.parallel.tensor_parallel import TensorParallelAttention, TensorParallelMLP

    blocks = [layer for tower in (replica.vision, replica.text) for layer in tower.encoder.layers]
    blocks.append(replica.vision.head)
    return all(isinstance(b.attn, TensorParallelAttention) and isinstance(b.mlp, TensorParallelMLP)
               and len(b.attn.shards) == len(b.mlp.shards) == mp for b in blocks)


def bytes_per_rank(state):
    """(parameter bytes, optimizer-state bytes) of the lead replica on each
    rank of its row; the replicated parameters count on rank 0."""
    params = dict(state.model.named_parameters())
    ranks = max(s.ranks for s in state.layout.values())
    p_bytes, o_bytes = [0] * ranks, [0] * ranks
    for name, p in params.items():
        p_bytes[state.layout[name].rank] += p.numel() * p.element_size()
    for tree in state.opt_state.values():
        for name, t in (tree.items() if isinstance(tree, dict) else ()):
            o_bytes[state.layout[name].rank] += t.numel() * t.element_size()
    return p_bytes, o_bytes


def phase_tp(mods, gpu, work, resident):
    """Phase 16: tensor-parallel towers on the card named 2 and 4 times;
    returns every counted kernel's launches on the tensor-parallel path."""
    import copy
    import dataclasses

    from tpuclip_torch.io.decode import load_image
    from tpuclip_torch.io.preprocess import preprocess_naflex, resize_to_uint8
    from tpuclip_torch.models.configs import DEFAULT_MODEL, get_config
    from tpuclip_torch.models.loader import load_model
    from tpuclip_torch.models.siglip import build_model, init_params_
    from tpuclip_torch.ops._counters import COUNTED
    from tpuclip_torch.parallel import make_mesh, shard_params
    from tpuclip_torch.parallel import training as tr
    from tpuclip_torch.parallel.tensor_parallel import gather_logical, logical_slice
    from tpuclip_torch.pipelines import train as train_mod
    from tpuclip_torch.text.tokenizer import build_prompt, load_tokenizer

    ops = mods[0]
    rows, m, scales = resident[:3]
    dev = rows.device
    cache = str(work / "models")
    report = {"gpu": gpu, "meshes": [list(x) for x in TP_MESHES]}
    for wrapper in COUNTED:
        wrapper.launches = 0

    # (a) image features of 64 of phase 4's JPEGs and text features of the
    # 4 masked texts, fp32 and bf16, each mesh against one device.
    cfg, model32 = load_model(DEFAULT_MODEL, cache, dev, torch.float32)
    files = sorted((work / "images").rglob("*.jpg"))[:TP_IMAGES]
    pixels = torch.from_numpy(np.stack([resize_to_uint8(load_image(str(f)), cfg.vision.image_size)
                                        for f in files])).to(dev)
    tokenizer = load_tokenizer(DEFAULT_MODEL, None, vocab_size=cfg.text.vocab_size)
    ids, mask = (torch.from_numpy(a).to(dev)
                 for a in tokenizer.encode_batch_with_mask([build_prompt(t) for t in TEXTS]))
    check(int(mask.sum(-1).min()) < mask.shape[1], "the texts' masks keep every token")
    features, timing = [], []
    txt_tp = txt_one = None
    for dtype, bar in ((torch.float32, 0.99999), (torch.bfloat16, 0.999)):
        base = model32 if dtype == torch.float32 else copy.deepcopy(model32).to(torch.bfloat16)
        img1, txt1 = base.get_image_features(pixels), base.get_text_features(ids, mask)
        one_ms = p50_ms(lambda: base.get_image_features(pixels), TP_REPS) if dtype == torch.bfloat16 else None
        for d, mp in TP_MESHES:
            replicas = shard_params(base, make_mesh([dev] * (d * mp), model_parallelism=mp))
            check(len(replicas) == d and all(split_over(r, mp) for r in replicas),
                  f"({d}, {mp}): the replicas are not split over the model axis")
            img = per_row(replicas, lambda r, x: r.get_image_features(x), pixels)
            txt = per_row(replicas, lambda r, i, k: r.get_text_features(i, k), ids, mask)
            ci, ct = cosines(img, img1), cosines(txt, txt1)
            norms = torch.cat([torch.linalg.vector_norm(x, dim=-1) for x in (img, txt)])
            case = {"dtype": str(dtype).removeprefix("torch."), "mesh": [d, mp],
                    "image_cos_min": float(ci.min()), "text_cos_min": float(ct.min()),
                    "image_max_abs": float((img - img1).abs().max()), "text_max_abs": float((txt - txt1).abs().max()),
                    "norm_err": float((norms - 1).abs().max())}
            check(bool(torch.isfinite(img).all() and torch.isfinite(txt).all()) and case["norm_err"] <= 1e-3,
                  f"tensor-parallel features not finite or off unit norm: {case}")
            check(min(case["image_cos_min"], case["text_cos_min"]) >= bar,
                  f"tensor-parallel features off one device's below cosine {bar}: {case}")
            features.append(case)
            print(f"[tp] (a) {case['dtype']} mesh (data {d}, model {mp}) of {dev} x {d * mp}: {TP_IMAGES} images, "
                  f"{len(TEXTS)} masked texts; cosine to one device min image {case['image_cos_min']:.8f}, text "
                  f"{case['text_cos_min']:.8f} (bar {bar}); max abs diff image {case['image_max_abs']:.3e}, text "
                  f"{case['text_max_abs']:.3e}; unit norm within {case['norm_err']:.1e}", flush=True)
            if dtype == torch.float32 and (d, mp) == (1, 2):
                txt_tp, txt_one = txt, txt1
            if dtype == torch.bfloat16 and d == 1:
                fn = functools.partial(replicas[0].get_image_features, pixels)
                tp_ms = p50_ms(fn, TP_REPS)
                _, busy, launches, _ = device_breakdown(fn, runs=2)
                _, busy1, launches1, _ = device_breakdown(lambda: base.get_image_features(pixels), runs=2)
                timing.append({"mesh": [d, mp], "tp_ms": tp_ms, "one_ms": one_ms, "tp_launches": launches,
                               "one_launches": launches1, "tp_busy_ms": busy, "one_busy_ms": busy1})
                print(f"[tp] (e) vision tower, batch {TP_IMAGES}, bf16: model axis {mp} p50 {tp_ms:.3f} ms, "
                      f"{launches:.0f} launches a call (device busy {busy:.3f} ms) against one device's "
                      f"{one_ms:.3f} ms, {launches1:.0f} launches (busy {busy1:.3f} ms); the card named {mp} "
                      f"times  ({gpu})", flush=True)
            del replicas
        del base
    report["features"], report["timing"] = features, timing
    torch.cuda.empty_cache()

    # (b) NaFlex: 16 of phase 11's images over the six aspect families, bf16,
    # at (1, 2).
    ncfg, naflex = load_model(NAFLEX_MODEL, cache, dev, torch.bfloat16)
    nfiles = sorted((work / "naflex_images").rglob("*.jpg"))[::12][:TP_NAFLEX]
    check(len({f.parent.name for f in nfiles}) == len(NAFLEX_SIZES), "the NaFlex images miss an aspect family")
    inputs = [preprocess_naflex(load_image(str(f)), ncfg.vision.patch_size, ncfg.vision.max_num_patches)
              for f in nfiles]
    patches, pmask, shapes = (torch.from_numpy(np.stack(x)).to(dev) for x in zip(*inputs))
    one = naflex.get_image_features_naflex(patches, pmask, shapes)
    replica = shard_params(naflex, make_mesh([dev, dev], model_parallelism=2))[0]
    check(split_over(replica, 2), "the NaFlex replica is not split over the model axis")
    got = replica.get_image_features_naflex(patches, pmask, shapes)
    cn = cosines(got, one)
    check(bool(torch.isfinite(got).all()) and float(cn.min()) >= 0.999,
          f"NaFlex tensor-parallel features off one device's: cosine min {float(cn.min())}")
    report["naflex"] = {"images": len(nfiles), "cos_min": float(cn.min()), "max_abs": float((got - one).abs().max())}
    print(f"[tp] (b) NaFlex ({NAFLEX_MODEL}), {len(nfiles)} images over {len(NAFLEX_SIZES)} aspect families, bf16, "
          f"mesh (data 1, model 2): cosine to one device min {float(cn.min()):.8f} (bar 0.999), max abs diff "
          f"{report['naflex']['max_abs']:.3e}", flush=True)
    del naflex, replica
    torch.cuda.empty_cache()

    # (c) the (1, 2) fp32 text features through the index's default int8
    # search (the fused search on the resident rows) over phase 3's rows.
    swaps = {}
    for q_count in (1, len(TEXTS)):
        s, i = ops.topk_int8_rerank_fused_auto(txt_tp[:q_count], m, scales, rows, K, n_valid=N_ROWS)
        with uncounted():
            s1, i1 = ops.topk_int8_rerank_fused_auto(txt_one[:q_count], m, scales, rows, K, n_valid=N_ROWS)
        check(bool(torch.isfinite(s).all()) and ordered(s.cpu(), i.cpu()), f"Q={q_count}: results not ordered")
        swaps[q_count] = same_ids_up_to_ties(s, i, s1, i1, 1e-5)
    torch.cuda.synchronize()
    launches = {wrapper.__name__: wrapper.launches for wrapper in COUNTED}
    check(launches["int8_scores"] > 0 and launches["int8_candidates_packed"] > 0,
          f"the tensor-parallel features' search did not launch kernels 1 and 2: {launches}")
    report["search"] = {"swapped_near_ties": swaps, "launches": launches}
    print(f"[tp] (c) (1, 2) fp32 text features, int8 search over {N_ROWS:,} rows, k {K}: a single query and the "
          f"{len(TEXTS)}-text batch, ids equal to one device's features' but for {swaps} swapped near-ties "
          f"(within 1e-5); kernel launches {launches}", flush=True)

    # (d) one data x model step at (2, 2), SO400M width at a cut depth, fp32
    # (TF32 off), against one device's step, AdamW then Adafactor.
    full = get_config(DEFAULT_MODEL)
    cfg4 = dataclasses.replace(full, vision=dataclasses.replace(full.vision, num_layers=DP_LAYERS),
                               text=dataclasses.replace(full.text, num_layers=DP_LAYERS))
    base = init_params_(build_model(cfg4, dev, torch.float32), torch.Generator(device=dev).manual_seed(16))
    batches = train_mod._batches(train_mod.find_pairs(str(work / "train_pairs")), DP_BATCH,
                                 cfg4.vision.image_size, tokenizer, 1, 0)
    images, tids, tmask = (torch.from_numpy(a).to(dev) for a in next(batches))
    batches.close()
    mesh = make_mesh([dev] * 4, model_parallelism=2)
    # The data x model gradients, gathered into logical tensors, against
    # one device's on the same masked batch: within 1e-5 of each leaf's
    # largest gradient. The leaves that reach the loss only through the
    # attention scores (q and k, weights and biases, and the MAP head's
    # probe, which feeds only its queries) are scaled by their attention
    # block's largest gradient instead: softmax's backward sums to zero over
    # the keys, so their gradients are small sums of large terms, and their
    # rounding follows the terms (a key bias's gradient is zero but for
    # rounding). Every leaf off its bar is listed before the check fails.
    single = copy.deepcopy(base).requires_grad_(True)
    loss1 = tr.sigmoid_contrastive_loss(single, images, tids, torch.float32, tmask)
    loss1.backward()
    want = {n: p.grad for n, p in single.named_parameters()}
    state = tr.init_train_state(copy.deepcopy(base), tr.make_optimizer(), mesh=mesh)
    loss_tp, grads = tr.data_parallel_value_and_grad(state, mesh, images, tids, tmask, torch.float32)
    got = gather_logical(grads, state.layout)
    block_max = {}
    for n, g in want.items():
        block = n.rsplit(".", 2)[0]
        if block.endswith(".attn"):
            block_max[block] = max(block_max.get(block, 0.0), float(g.abs().max()))
    grad_worst = own_worst = 0.0
    off = []
    for n, g in want.items():
        block, proj = n.rpartition(".")[0].rpartition(".")[::2]
        if n.endswith("head.probe"):
            block, proj = n.removesuffix("probe") + "attn", "q"
        own = float(g.abs().max())
        scale = block_max[block] if block.endswith(".attn") and proj in ("q", "k") else own
        err = float((got[n].to(dev) - g).abs().max())
        if err > 1e-5 * scale:
            off.append(f"{n} by {err:.3e} (bar 1e-5 x {scale:.3e})")
        grad_worst = max(grad_worst, err / max(scale, 1e-30))
        own_worst = max(own_worst, err / max(own, 1e-30))
    check(not off, f"{len(off)} gradients off one device's: " + "; ".join(off))
    grad_loss_rel = abs(loss_tp.item() - loss1.item()) / abs(loss1.item())
    check(grad_loss_rel <= 1e-5, f"data x model loss {loss_tp.item()} off one device's {loss1.item()}")
    report["grads"] = {"leaves": len(want), "worst_err_over_scale": grad_worst,
                       "worst_err_over_own_max": own_worst, "loss_rel": grad_loss_rel}
    print(f"[tp] (d) gradients of one masked batch of {DP_BATCH}, fp32, mesh (data 2, model 2): all {len(want)} "
          f"leaves gathered from their shards within {grad_worst:.2e} of their scale (bar 1e-5; each leaf's "
          f"largest gradient, the attention block's for q, k and the probe), {own_worst:.2e} of each leaf's own "
          f"largest; "
          f"loss {grad_loss_rel:.2e} relative  ({gpu})", flush=True)
    del single, want, state, grads, got
    torch.cuda.empty_cache()
    steps = {}
    for factored in (False, True):
        name = "adafactor" if factored else "adamw"
        opt1 = tr.make_optimizer(learning_rate=1e-5, factored=factored)
        single = tr.init_train_state(copy.deepcopy(base), opt1)
        step1 = tr.make_train_step(opt1, torch.float32)
        single, loss1 = step1(single, images, tids, tmask)
        want = {n: p.detach().clone() for n, p in single.model.named_parameters()}
        # |g| of one device's step: AdamW's first moment is then 0.1 g.
        grad_abs = None if factored else {n: mu.abs() * 10 for n, mu in single.opt_state["mu"].items()}
        trace1 = device_breakdown(lambda: step1(single, images, tids, tmask), runs=2)
        print_breakdown("tp", f"(d) one-device {name} step, fp32, batch {DP_BATCH}", trace1, gpu)
        del single
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        opt = tr.make_optimizer(learning_rate=1e-5, factored=factored)
        state = tr.init_train_state(copy.deepcopy(base), opt, mesh=mesh)
        check(all(split_over(r, 2) for r in state.replicas), "the train replicas are not split")
        step = tr.make_train_step(opt, torch.float32, mesh=mesh)
        times, losses = [], []
        for n_step in range(TP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, images, tids, tmask)
            losses.append(loss.item())
            times.append(time.perf_counter() - t0)
            if n_step == 0:
                # Each shard against its slice of one device's parameter:
                # within 1e-5 of the leaf's largest update plus one fp32
                # rounding of its largest value. Not held, but counted: the
                # attention key biases, whose gradients are zero but for
                # rounding (both optimizers scale that noise to full
                # steps), and under AdamW the elements whose |g| < 100 eps,
                # where its first step g / (|g| + eps) scales the gradient's
                # rounding by up to eps / |g|.
                worst, worst_kbias, near_eps = 0.0, 0.0, 0
                for n, p in state.model.named_parameters():
                    logical = state.layout[n].logical
                    ref = logical_slice(want[logical], n, state.layout)
                    moved = float((want[logical] - base.get_parameter(logical)).abs().max())
                    ulp = float(np.spacing(np.float32(want[logical].abs().max().item())))
                    diff = (p.detach() - ref).abs()
                    if logical.endswith("attn.k.bias"):
                        worst_kbias = max(worst_kbias, float(diff.max()) / max(moved, 1e-30))
                        continue
                    over = diff > 1e-5 * moved + ulp
                    if grad_abs is not None:
                        small = logical_slice(grad_abs[logical], n, state.layout) < 100 * tr._EPS
                        near_eps += int((over & small).sum())
                        over &= ~small
                        diff = diff.masked_fill(small, 0.0)
                    check(not bool(over.any()), f"{name}: {n} off one device's step by {float(diff.max()):.3e} "
                          f"(largest update {moved:.3e}, one rounding {ulp:.3e})")
                    worst = max(worst, float((diff - ulp).clamp_min(0).max()) / max(moved, 1e-30))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        loss_rel = abs(losses[0] - loss1.item()) / abs(loss1.item())
        check(loss_rel <= 1e-4 and all(np.isfinite(losses)),
              f"{name}: data x model loss {losses[0]} off one device's {loss1.item()} by {loss_rel:.2e}")
        replicas_equal = all(torch.equal(p, state.model.get_parameter(n)) for n, p in state.replicas[1].named_parameters())
        check(replicas_equal, f"{name}: the two rows' replicas differ after the steps")
        trace = device_breakdown(lambda: step(state, images, tids, tmask), runs=2)
        print_breakdown("tp", f"(d) data x model {name} step, fp32, batch {DP_BATCH}, mesh (data 2, model 2)",
                        trace, gpu)
        p_bytes, o_bytes = bytes_per_rank(state)
        steps[name] = {"loss_single": loss1.item(), "losses": losses, "loss_rel": loss_rel,
                       "worst_err_over_update": worst, "kbias_err_over_update": worst_kbias,
                       "near_eps_elements_over": near_eps,
                       "step_p50_s": statistics.median(times[1:]), "peak_bytes": peak, "held_bytes": held,
                       "param_bytes_per_rank": p_bytes, "opt_bytes_per_rank": o_bytes,
                       "trace": trace, "trace_single": trace1}
        print(f"[tp] (d) data x model step, {name}, fp32, SO400M width ({cfg4.vision.hidden_size} hidden, "
              f"{cfg4.vision.num_heads} heads, MLP {cfg4.vision.intermediate_size}), {DP_LAYERS} layers a tower, "
              f"batch {DP_BATCH}, mesh (data 2, model 2) of {dev} x 4: first loss {losses[0]:.7f} vs one device "
              f"{loss1.item():.7f} ({loss_rel:.2e} relative); parameters after the step within {worst:.2e} of each "
              f"leaf's largest update beyond one rounding (key biases {worst_kbias:.2e} and {near_eps} AdamW elements "
              f"with |g| < 100 eps over it, not held); rows equal; "
              f"losses {', '.join(f'{x:.7f}' for x in losses)}; step p50 {steps[name]['step_p50_s'] * 1e3:.1f} ms "
              f"after step 1; peak {peak:,} bytes over {held:,} held; parameter bytes per rank {p_bytes}, "
              f"optimizer bytes per rank {o_bytes}  ({gpu})", flush=True)
        del state, want, grad_abs
        torch.cuda.empty_cache()
    report["train"] = steps
    del base, model32
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    launches = {wrapper.__name__: wrapper.launches for wrapper in COUNTED}
    print(f"[tp] kernel launches on the tensor-parallel path: {launches}", flush=True)
    report["launches"] = launches
    print("[phase16-json] " + json.dumps(report), flush=True)
    return launches


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ab", action="append", default=[], metavar="LABEL:PATH",
                        help="another int8_scan.cu (kernels 2 and 3), binary_scan.cu (kernels 6 "
                             "and 7), topk_bf16.cu (kernel 4) or patch_embed.cu (kernel 8) to time "
                             "against this tree's, in turns")
    parser.add_argument("--mesh-worker", nargs=3, metavar=("RANK", "PORT", "OUT"),
                        help="run as one of phase 14's two gloo processes (started by the smoke itself)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if args.mesh_worker:
        rank, port, out = args.mesh_worker
        return mesh_worker(int(rank), port, out)
    from tpuclip_torch.ops import _build
    from tpuclip_torch.ops import attention as aops
    from tpuclip_torch.ops import hamming as hops
    from tpuclip_torch.ops import layernorm as lops
    from tpuclip_torch.ops import patch_embed as pops
    from tpuclip_torch.ops import swiglu as sops
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
    binary, binary_rows = phase_binary_kernels(hops, gpu, variants.get("binary_scan.cu"))
    record.update(binary)
    torch.cuda.empty_cache()
    record["patch_embed_fused"] = phase_patch_embed(pops, gpu, variants.get("patch_embed.cu"))
    torch.cuda.empty_cache()
    record["attention"] = phase_attention(aops, gpu)
    torch.cuda.empty_cache()
    record["add_layer_norm"] = phase_add_layernorm(lops, gpu)
    torch.cuda.empty_cache()
    record["silu_mul"] = phase_dinov2_kernels(lops, sops, gpu)
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
        # Phase 15 runs here, while phase 4's engine and phase 3's rows are resident.
        shortlist = phase_shortlist(mods, gpu, resident, engine)
        torch.cuda.empty_cache()
        session = phase_cli(gpu, Path(tmp), db)
        del engine
        naflex = phase_naflex(mods, gpu, Path(tmp), resident)
        torch.cuda.empty_cache()
        so384 = phase_so400m_384(mods, gpu, Path(tmp), resident)
        torch.cuda.empty_cache()
        dino = phase_dinov2(gpu, Path(tmp))
        torch.cuda.empty_cache()
        record["rope"] = phase_dinov3_kernels(lops, gpu)
        torch.cuda.empty_cache()
        dino3 = phase_dinov3(gpu, Path(tmp))
        torch.cuda.empty_cache()
        ivf, ivf_ctx = phase_ivf(mods, gpu, Path(tmp), db)
        torch.cuda.empty_cache()
        train = phase_train(gpu, Path(tmp))
        torch.cuda.empty_cache()
        mesh = phase_mesh(mods, gpu, Path(tmp), db, cache, resident, binary_rows, ivf_ctx)
        del binary_rows, ivf_ctx
        torch.cuda.empty_cache()
        tp = phase_tp(mods, gpu, Path(tmp), resident)
        del resident

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
        "attention": ("tpuclip_torch/csrc/attention.cu", None),
        "attention_sm90": ("tpuclip_torch/csrc/attention_sm90.cu", None),
        "add_layer_norm": ("tpuclip_torch/csrc/add_layernorm.cu", None),
        "silu_mul": ("tpuclip_torch/csrc/silu_mul.cu", None),
        "rope": ("tpuclip_torch/csrc/rope2d.cu", None),
    }
    # Kernel 9's Hopper design: its launches (a share of "attention"'s) and
    # phase 3's record of the two designs in turns.
    record["attention_sm90"] = {key: record["attention"].pop(key) for key in ("designs", "ptxas")}
    launches["binary_topk_batched_q16"] = launches["binary_topk_batched"]  # one kernel, two cases
    kernels = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], **paths.get(name, {}),
         "launches_session": session[name.removesuffix("_q16")],
         "launches_naflex": naflex[name.removesuffix("_q16")],
         "launches_so400m_384": so384[name.removesuffix("_q16")],
         "launches_ivf": ivf[name.removesuffix("_q16")],
         "launches_train": train[name.removesuffix("_q16")],
         "launches_mesh": mesh[name.removesuffix("_q16")],
         "launches_shortlist": shortlist[name.removesuffix("_q16")],
         "launches_tp": tp[name.removesuffix("_q16")],
         "launches_dinov2": dino[name.removesuffix("_q16")],
         "launches_dinov3": dino3[name.removesuffix("_q16")], **record[name]}
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
