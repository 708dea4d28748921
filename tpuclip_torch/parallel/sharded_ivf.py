"""Mesh-sharded IVF search (PyTorch port of ``tpuclip/parallel/sharded_ivf.py``).

The IVF index (``index/ivf.py``) is sharded over the mesh's data axis by
cluster:

- the centroids stay replicated ((K, D) f32, one copy per device), so the
  probe needs no communication; they are padded to a multiple of the data
  axis in lockstep with the cluster axis, and the padding clusters score
  -inf (``k_real``), so a probe slot never goes to one;
- the buckets, their scales and row ids shard over the cluster axis: each
  shard owns K_pad / ndev whole (C, D) buckets;
- ``bucket_rows_full`` embeds each bucket slot's storage-dtype row beside
  it, so a shard rescores its candidates exactly without fetching rows
  from another device (capacity_factor x the rows, sharded);
- the overflow block is split by rows across the shards; every query
  scans its shard's slice, so no row is unreachable.

A query probes each shard's own top-ceil(nprobe / ndev) buckets (tpuclip's
per-shard spread, not a global top-nprobe), scores them and the overflow
slice in int8 on kernel 1 as the single-device probe does, rescores a
shortlist of max(4k, 64) against the embedded rows with the bf16-rounded
query, and keeps its exact top-k; the shards' top-ks are merged as in
``sharded_search``. With nprobe = K the result is the exact search's.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpuclip_torch.index.ivf import IVFIndex, _top_positions
from tpuclip_torch.ops.topk_int8 import _final_merge, int8_scores, quantize_queries, round_f32_to_bf16_bits
from tpuclip_torch.parallel.mesh import DATA_AXIS, Mesh
from tpuclip_torch.parallel.sharded_search import ShardedTensor, _merge_shard_candidates, shard_matrix

_NEG_INF = float("-inf")
_INT32_MAX = 2**31 - 1


class ShardedIVF(NamedTuple):
    """An IVFIndex resharded for a mesh, with embedded full-precision rows."""

    centroids: List[torch.Tensor]    # (K_pad, D) f32, one replica per local shard
    buckets: ShardedTensor           # (K_pad, C, D) int8, cluster-sharded
    bucket_scales: ShardedTensor     # (K_pad, C) f32
    bucket_rows: ShardedTensor       # (K_pad, C) int32 global ids (-1 empty)
    bucket_rows_full: ShardedTensor  # (K_pad, C, D) storage dtype
    overflow: ShardedTensor          # (O_pad, D) int8, row-sharded
    over_scales: ShardedTensor       # (O_pad,) f32
    over_rows: ShardedTensor         # (O_pad,) int32 (-1 padding)
    over_rows_full: ShardedTensor    # (O_pad, D) storage dtype
    nprobe: int
    mesh: Mesh
    n_rows: int
    k_real: int  # clusters before the mesh padding

    def nbytes(self) -> int:
        """Bytes of this process's tensors (each distinct centroid replica once)."""
        replicas = {t.data_ptr(): t.numel() * 4 for t in self.centroids}
        return sum(replicas.values()) + sum(t.nbytes() for t in self[1:9])


def _pad_axis0(x: torch.Tensor, mult: int, fill=0) -> torch.Tensor:
    rem = (-x.shape[0]) % mult
    if not rem:
        return x
    return torch.cat([x, x.new_full((rem, *x.shape[1:]), fill)])


def _embed_rows(rows_full, ids: torch.Tensor, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    """The rows of ``rows_full`` (a tensor anywhere, or a host array such as
    the fp32 memmap) at ``ids`` (-1: a zero row), in ``dtype``, on
    ``device``."""
    flat = ids.reshape(-1)
    valid = flat >= 0
    n_rows = rows_full.shape[0]
    if torch.is_tensor(rows_full):
        safe = flat.clamp(0, n_rows - 1).to(rows_full.device)
        got = rows_full[safe]
        got = got.masked_fill(~valid.to(got.device)[:, None], 0)
    else:
        safe = np.clip(flat.cpu().numpy(), 0, n_rows - 1)
        got = torch.from_numpy(np.asarray(rows_full[safe], np.float32))
        got = got.masked_fill(~valid.cpu()[:, None], 0)
    return got.to(device=device, dtype=dtype or got.dtype).reshape(*ids.shape, -1)


def shard_ivf(index: IVFIndex, rows_full, mesh: Mesh, dtype: Optional[torch.dtype] = None) -> ShardedIVF:
    """Reshard a built :class:`IVFIndex` onto ``mesh`` and embed each slot's
    full-precision row from ``rows_full`` (an (N, D) tensor in the storage
    dtype, or the host fp32 rows with ``dtype`` naming the storage dtype).

    The build (k-means, assignment, balanced fill) ran wherever
    ``build_ivf`` / ``build_ivf_device`` ran; this pads the cluster and
    overflow axes to the mesh size (centroids in lockstep, padding slots
    with row id -1 and zero rows) and places each shard's blocks on its
    device, gathering only that shard's rows."""
    ndev = mesh.shape[DATA_AXIS]
    cent = _pad_axis0(index.centroids.float(), ndev)
    parts = {
        "buckets": _pad_axis0(index.buckets, ndev),
        "bucket_scales": _pad_axis0(index.bucket_scales, ndev),
        "bucket_rows": _pad_axis0(index.bucket_rows, ndev, -1),
        # Slices of 16 rows: each shard's scales start 16-byte aligned.
        "overflow": _pad_axis0(index.overflow, 16 * ndev),
        "over_scales": _pad_axis0(index.over_scales, 16 * ndev),
        "over_rows": _pad_axis0(index.over_rows, 16 * ndev, -1),
    }
    sharded = {name: shard_matrix(t, mesh) for name, t in parts.items()}
    full = {}
    for name, ids in (("bucket_rows_full", sharded["bucket_rows"]), ("over_rows_full", sharded["over_rows"])):
        shards = [_embed_rows(rows_full, t, dtype, dev) for t, dev in zip(ids.shards, mesh.data_devices)]
        full[name] = ShardedTensor(shards, ids.rows_per_shard, mesh)
    replicas: Dict[torch.device, torch.Tensor] = {}
    for dev in mesh.data_devices:
        replicas.setdefault(dev, cent.to(dev))
    return ShardedIVF(
        centroids=[replicas[dev] for dev in mesh.data_devices],
        buckets=sharded["buckets"], bucket_scales=sharded["bucket_scales"],
        bucket_rows=sharded["bucket_rows"], bucket_rows_full=full["bucket_rows_full"],
        overflow=sharded["overflow"], over_scales=sharded["over_scales"],
        over_rows=sharded["over_rows"], over_rows_full=full["over_rows_full"],
        nprobe=int(index.nprobe), mesh=mesh, n_rows=int(rows_full.shape[0]),
        k_real=int(index.centroids.shape[0]),
    )


def _search_shard(index: ShardedIVF, j: int, q: torch.Tensor, k_eff: int, p_local: int):
    """One shard's exact top-min(k_eff, m) over its probed buckets and its
    overflow slice: ((Q, <= k_eff) f32, (Q, <= k_eff) int64 global rows)."""
    mesh = index.mesh
    kl = index.buckets.rows_per_shard
    bks, bsc = index.buckets.shards[j], index.bucket_scales.shards[j]
    brw, bfl = index.bucket_rows.shards[j], index.bucket_rows_full.shards[j]
    ovt, ovs = index.overflow.shards[j], index.over_scales.shards[j]
    ovr, ofl = index.over_rows.shards[j], index.over_rows_full.shards[j]
    q_count, d = q.shape
    cap = bks.shape[1]
    qi, _ = quantize_queries(q)

    # 1. probe MY clusters; padding clusters (global id >= k_real) score -inf.
    first = mesh.shard_index(j) * kl
    cscores = q @ index.centroids[j][first : first + kl].T
    cid = first + torch.arange(kl, device=q.device)
    cscores = cscores.masked_fill(cid[None, :] >= index.k_real, _NEG_INF)
    probe = _top_positions(cscores, p_local)  # (Q, P) local cluster ids
    p = probe.shape[1]

    # 2. the probed buckets, one contiguous (P*C, D) slab a query, on kernel 1.
    bucket_s = torch.empty((q_count, p * cap), dtype=torch.float32, device=q.device)
    for i in range(q_count):
        slab = bks[probe[i]].view(p * cap, d)
        bucket_s[i] = int8_scores(qi[i : i + 1], slab, bsc[probe[i]].view(-1), p * cap)[0]
    bucket_r = brw[probe].view(q_count, p * cap)

    # 3. MY slice of the overflow block.
    over_s = int8_scores(qi, ovt, ovs, ovt.shape[0])
    cand_s = torch.cat([bucket_s, over_s], dim=1)
    cand_r = torch.cat([bucket_r, ovr.expand(q_count, -1)], dim=1)
    cand_s = cand_s.masked_fill(cand_r < 0, _NEG_INF)

    # 4. shortlist, then the exact rescore against the EMBEDDED rows: a
    #    position below P*C is slot (probe[pos // C], pos % C), the rest the
    #    overflow slice's row pos - P*C.
    m = min(max(4 * k_eff, 64), cand_s.shape[1])
    pos = _top_positions(cand_s, m)
    top_s = cand_s.gather(1, pos)
    cand = cand_r.gather(1, pos).long()
    in_bucket = pos < p * cap
    bucket_of = probe.gather(1, (pos // cap).clamp(max=p - 1))
    from_buckets = bfl[bucket_of, pos % cap]
    from_overflow = ofl[(pos - p * cap).clamp(0, max(ofl.shape[0] - 1, 0))]
    gathered = torch.where(in_bucket[..., None], from_buckets, from_overflow).float()
    qr = round_f32_to_bf16_bits(q) if bfl.dtype == torch.bfloat16 else q
    exact = (gathered * qr[:, None, :]).sum(dim=-1)
    invalid = (cand < 0) | (cand >= index.n_rows) | torch.isneginf(top_s)
    exact = exact.masked_fill(invalid, _NEG_INF)
    gi = cand.masked_fill(invalid, _INT32_MAX)

    # 5. this shard's exact top-k, (score desc, row asc).
    return _final_merge(exact, gi, min(k_eff, m))


def sharded_ivf_search(
    index: ShardedIVF, q_f32, k: int, nprobe: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a mesh-sharded IVF index: each shard probes its local
    top-ceil(nprobe / ndev) buckets plus its overflow slice and rescores
    its candidates exactly against the embedded rows; the shards' (Q, k)
    candidates merge into the global (score desc, row asc) top-k. Returns
    ((Q, k) f32, (Q, k) int64) on the lead device; the scores are the
    exact full-precision dots. ``q_f32`` may be host numpy."""
    mesh = index.mesh
    if not torch.is_tensor(q_f32):
        q_f32 = torch.from_numpy(np.ascontiguousarray(q_f32, np.float32))
    q_f32 = q_f32.float().reshape(-1, index.centroids[0].shape[1])
    ndev = mesh.shape[DATA_AXIS]
    kl = index.buckets.rows_per_shard
    p_local = max(1, min(-(-int(nprobe if nprobe is not None else index.nprobe) // ndev), kl))
    k_eff = min(k, index.n_rows)
    parts = [
        _search_shard(index, j, q_f32.to(dev), k_eff, p_local) for j, dev in enumerate(mesh.data_devices)
    ]
    return _merge_shard_candidates(parts, mesh, k_eff)
