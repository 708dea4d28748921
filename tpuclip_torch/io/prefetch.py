"""Parallel decode + prefetching batch pipeline.

The reference decodes serially inside the batched embed call
(image_database.py:471-479) — the device idles while Python/PIL works. Here a
thread pool decodes and resizes ahead of the device, and a bounded queue of
*fixed-shape* uint8 batches keeps exactly one compiled program hot:

    paths ──► ThreadPool(decode+resize, CPU) ──► bounded queue ──► device

- Fixed batch shape (last batch zero-padded, validity tracked) → one XLA
  compilation, no shape polymorphism.
- PIL decode/resize release the GIL in their C cores, so threads scale to
  physical cores without multiprocessing overhead.
- On hosts where per-image *Python* overhead (not the C cores) becomes the
  bottleneck at high core counts, a process pool sidesteps the GIL entirely:
  set ``TPUCLIP_DECODE_PROCS=N`` (or ``--decode-procs N``) to decode in N
  spawned worker processes. Workers import only PIL/numpy/hashlib — never
  jax — so spawn is cheap and cannot double-initialize the accelerator. The
  decoded (224,224,3) uint8 arrays are ~150 KB each, so IPC pickling costs
  ~25 MB/s even at 10k img/min — negligible.
- The queue depth bounds host memory (depth × batch × 224² × 3 bytes).
- File hashing rides the same worker task as decode (the bytes are already
  hot in the page cache), removing the reference's separate serial hash loop
  (image_database.py:954-963).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Executor, ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from tpuclip_torch.io.decode import load_image, load_image_bytes
from tpuclip_torch.io.hashing import file_sha256
from tpuclip_torch.io.preprocess import resize_to_uint8


@dataclass
class DecodedImage:
    path: str
    last_modified: float
    pixels: Optional[np.ndarray]  # uint8 (S, S, 3) — or (L, P*P*C) patches in naflex mode
    file_hash: Optional[str]
    mask: Optional[np.ndarray] = None  # naflex: (L,) 1=real patch
    shape: Optional[Tuple[int, int]] = None  # naflex: (h, w) patch grid
    # Scan-time reuse: the embedding (and the source row's binary blob) of an
    # already-indexed byte-identical file. When set, pixels is None and the
    # consumer commits these instead of embedding (decode was skipped).
    reused_embedding: Optional[np.ndarray] = None
    reused_binary: Optional[bytes] = None


@dataclass
class Batch:
    pixels: np.ndarray  # uint8 (B, S, S, 3) — or (B, L, P*P*C) in naflex mode
    items: List[DecodedImage]  # len <= B; items[i] corresponds to pixels[i]
    valid: np.ndarray  # bool (B,) — True where pixels are a real decode
    masks: Optional[np.ndarray] = None  # naflex: (B, L) int32
    shapes: Optional[np.ndarray] = None  # naflex: (B, 2) int32


def _fast_decode_level() -> int:
    """0 = exact decode; 1 = DCT draft that never upsamples (mean pixel
    diff ~0.07/255, docs/benchmarks.md); 2 = aggressive draft covering
    image_size/2 — decoded frame may be upsampled up to 2x by the final
    resize. Level 2 trades visible high-frequency detail (mean pixel diff
    ~3/255 on 1024x768 q85 photos) for ~25% less decode time; opt-in for
    decode-bound hosts where indexing throughput matters more than exact
    preprocessing parity."""
    v = os.environ.get("TPUCLIP_FAST_DECODE", "")
    if v in ("1", "true", "yes"):
        return 1
    if v == "2":
        return 2
    return 0


def _decode_one(
    path: str,
    last_modified: float,
    image_size: int,
    with_hash: bool,
    naflex: Optional[Tuple[int, int]] = None,
    reuse_lookup=None,
) -> DecodedImage:
    """``naflex``: (patch_size, max_num_patches) switches output from a
    square resize to native-aspect patchification (io.preprocess)."""
    level = _fast_decode_level()
    draft = (
        None if level == 0
        else image_size if level == 1
        else max(1, image_size // 2)
    )

    def reuse_hit(file_hash):
        """DecodedImage carrying an already-indexed byte-identical file's
        embedding + binary blob, or None (lookup miss or failure)."""
        if reuse_lookup is None:
            return None
        try:
            hit = reuse_lookup(file_hash)
        except Exception:  # noqa: BLE001 - reuse is best-effort
            hit = None
        if hit is None:
            return None
        vec, blob = hit
        return DecodedImage(
            path, last_modified, None, file_hash,
            reused_embedding=vec, reused_binary=blob,
        )

    def finish(img, file_hash):
        if img is None:
            return DecodedImage(path, last_modified, None, file_hash)
        if naflex is not None:
            from tpuclip_torch.io.preprocess import preprocess_naflex

            patches, mask, shape = preprocess_naflex(img, naflex[0], naflex[1])
            return DecodedImage(path, last_modified, patches, file_hash, mask, shape)
        return DecodedImage(
            path, last_modified, resize_to_uint8(img, image_size), file_hash
        )

    if with_hash and not path.lower().endswith(".pdf"):
        # Read once: the same bytes feed the hash and the decoder (PDFs keep
        # the two-pass path since fitz renders from the file).
        import hashlib

        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return DecodedImage(path, last_modified, None, None)
        file_hash = hashlib.sha256(data).hexdigest()
        # A byte-identical file already indexed skips decode+embed entirely.
        reused = reuse_hit(file_hash)
        if reused is not None:
            return reused
        cached = _decode_cache_get(file_hash, image_size, level, naflex)
        if cached is not None:
            return DecodedImage(path, last_modified, cached, file_hash)
        out = finish(load_image_bytes(data, path, draft_size=draft), file_hash)
        _decode_cache_put(out, file_hash, image_size, level, naflex)
        return out
    # PDF path: fitz renders from the file, so hash FIRST (cheap read, page
    # cache warm for the render) — a reuse hit then skips the render too.
    file_hash = None
    if with_hash:
        try:
            file_hash = file_sha256(path)
        except OSError:
            return DecodedImage(path, last_modified, None, None)
        reused = reuse_hit(file_hash)
        if reused is not None:
            return reused
    img = load_image(path, draft_size=draft)
    return finish(img, file_hash)


def _decode_cache_key(file_hash: str, image_size: int, level: int) -> str:
    # Content-addressed: keyed by the file's sha256 plus everything that
    # changes the decoded pixels (target size, fast-decode level). A
    # re-scan of the same bytes at the same settings is a pure cache hit.
    return f"{file_hash}_{image_size}_l{level}.npy"


def _decode_cache_get(file_hash, image_size, level, naflex):
    """Resized-uint8 pixels for this (content, settings) from the decode
    cache, or None. Enabled by TPUCLIP_DECODE_CACHE=<dir>; square mode only
    (naflex batches carry variable patch/mask/shape triples — not worth the
    cache complexity for the one mode that benefits)."""
    cache = os.environ.get("TPUCLIP_DECODE_CACHE")
    if not cache or naflex is not None or file_hash is None:
        return None
    try:
        px = np.load(os.path.join(cache, _decode_cache_key(file_hash, image_size, level)))
    except (OSError, ValueError):
        return None
    if px.dtype != np.uint8 or px.shape != (image_size, image_size, 3):
        return None  # stale/corrupt entry: fall through to a real decode
    return px


def _decode_cache_put(item: DecodedImage, file_hash, image_size, level, naflex) -> None:
    cache = os.environ.get("TPUCLIP_DECODE_CACHE")
    if not cache or naflex is not None or file_hash is None or item.pixels is None:
        return
    try:
        os.makedirs(cache, exist_ok=True)
        final = os.path.join(cache, _decode_cache_key(file_hash, image_size, level))
        # Atomic publish: concurrent decode workers may race on one entry;
        # whoever renames last wins with identical bytes.
        tmp = f"{final}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            np.save(f, item.pixels)
        os.replace(tmp, final)
    except OSError:
        pass  # cache is best-effort; the decode already succeeded


def gc_decode_cache(cache_dir: str, max_bytes: Optional[int] = None,
                    dry_run: bool = False):
    """Bound the content-addressed decode cache (review r4: every unique
    (sha256, size, level) writes a ~150 KB .npy forever — 1M images ≈
    150 GB — and entries from old image_size/level settings are never
    cleaned). Evicts oldest-mtime entries until the cache fits
    ``max_bytes`` (None = report only), and always drops stale ``*.tmp``
    publish leftovers (>1 h old). Reads don't touch mtime, so this is
    FIFO-by-write-time — the right policy for a cache whose hits are
    re-scans of recently indexed trees.

    Returns (n_removed, bytes_reclaimed, bytes_kept)."""
    entries = []  # (mtime, size, path)
    now = time.time()
    removed, reclaimed = 0, 0
    try:
        it = os.scandir(cache_dir)
    except OSError:
        return 0, 0, 0
    with it:
        for de in it:
            try:
                st = de.stat()
            except OSError:
                continue
            if de.name.endswith(".tmp"):
                # Orphaned atomic-publish temp (writer died mid-put).
                if now - st.st_mtime > 3600:
                    removed += 1
                    reclaimed += st.st_size
                    if not dry_run:
                        try:
                            os.unlink(de.path)
                        except OSError:
                            pass
                continue
            if de.name.endswith(".npy"):
                entries.append((st.st_mtime, st.st_size, de.path))
    total = sum(sz for _, sz, _ in entries)
    if max_bytes is not None and total > max_bytes:
        entries.sort()  # oldest first
        for _mt, sz, path in entries:
            if total <= max_bytes:
                break
            removed += 1
            reclaimed += sz
            total -= sz
            if not dry_run:
                try:
                    os.unlink(path)
                except OSError:
                    pass
    return removed, reclaimed, total


def _env_int(name: str, default: int) -> int:
    """Malformed numeric env knobs fall back to the default with a warning
    (a bare int() would raise from inside the producer thread with a
    traceback that never names the variable)."""
    env = os.environ.get(name)
    if not env:
        return default
    try:
        return int(env)
    except ValueError:
        from tpuclip_torch.utils.logging import log

        log(f"  [WARNING] ignoring malformed {name}={env!r}")
        return default


def default_workers() -> int:
    # One worker per core: a second decode thread on a 1-core host only adds
    # context-switch overhead (measured 161 vs 191 img/s single-thread).
    return max(1, _env_int(
        "TPUCLIP_DECODE_WORKERS", max(1, min(32, (os.cpu_count() or 4)))
    ))


def default_procs() -> int:
    """Decode worker *processes*; 0 (default) = in-process thread pool."""
    return max(0, _env_int("TPUCLIP_DECODE_PROCS", 0))


def _make_decode_executor(num_workers: Optional[int], num_procs: Optional[int]) -> Executor:
    procs = default_procs() if num_procs is None else num_procs
    if procs > 0:
        import multiprocessing as mp

        # spawn, not fork: the parent holds a live jax runtime and decode
        # threads; forking either is unsafe. Workers re-import only the
        # jax-free decode modules, so spawn startup is light.
        return ProcessPoolExecutor(max_workers=procs, mp_context=mp.get_context("spawn"))
    return ThreadPoolExecutor(max_workers=num_workers or default_workers())


def prefetch_batches(
    files: Iterable[Tuple[str, float]],
    batch_size: int,
    image_size: int,
    num_workers: Optional[int] = None,
    queue_depth: int = 4,
    with_hash: bool = True,
    stop_event: Optional[threading.Event] = None,
    num_procs: Optional[int] = None,
    naflex: Optional[Tuple[int, int]] = None,
    reuse_lookup=None,
) -> Iterator[Batch]:
    """Yield fixed-shape decoded batches, decoding ahead of the device.

    ``files``: iterable of (path, last_modified). Order is preserved.
    ``num_procs`` > 0 decodes in spawned worker processes instead of threads
    (default: ``TPUCLIP_DECODE_PROCS`` env, else a thread pool).
    ``naflex``: (patch_size, max_num_patches) yields patchified batches with
    masks/shapes instead of square pixel batches (still fixed-shape).
    ``reuse_lookup``: optional ``hash -> (embedding, binary-blob-or-None)``
    callable (None = miss); hits skip decode and come back as
    ``DecodedImage.reused_embedding`` / ``reused_binary`` slots.
    Thread-pool only — a closure over a SQLite connection can't cross a
    process boundary, so it is dropped (with the decode still correct)
    when worker processes are selected.
    """
    if reuse_lookup is not None:
        procs = default_procs() if num_procs is None else num_procs
        if procs > 0:
            reuse_lookup = None
    out_q: "queue.Queue[Optional[Batch]]" = queue.Queue(maxsize=queue_depth)
    error_holder: List[BaseException] = []
    if stop_event is None:
        # Own the stop signal: an early consumer exit (generator close) must
        # be able to halt the producer, or it keeps decoding — forever on an
        # infinite ``files`` stream — blocked on the bounded queue.
        stop_event = threading.Event()

    def producer() -> None:
        try:
            pool = _make_decode_executor(num_workers, num_procs)
            try:
                pending: List = []

                def flush() -> None:
                    nonlocal pool
                    if not pending:
                        return
                    # Per-file containment even when a WORKER PROCESS dies
                    # (segfault in a codec): BrokenProcessPool poisons every
                    # in-flight future AND the pool itself — map the batch's
                    # slots to decode failures and rebuild the pool so the
                    # rest of the scan proceeds (a bad file must never kill
                    # a scan).
                    items = []
                    broken = False
                    for f, path, lm in pending:
                        try:
                            items.append(f.result())
                        except Exception as e:  # noqa: BLE001
                            items.append(DecodedImage(path, lm, None, None))
                            from concurrent.futures import BrokenExecutor

                            if isinstance(e, BrokenExecutor):
                                broken = True
                    if broken:
                        from tpuclip_torch.utils.logging import log

                        log(
                            "  [WARNING] a decode worker process crashed; "
                            "containing the batch and rebuilding the pool"
                        )
                        try:
                            pool.shutdown(wait=False)
                        except Exception:  # noqa: BLE001
                            pass
                        pool = _make_decode_executor(num_workers, num_procs)
                    valid = np.zeros((batch_size,), bool)
                    if naflex is not None:
                        p, L = naflex
                        pixels = np.zeros((batch_size, L, p * p * 3), np.uint8)
                        masks = np.zeros((batch_size, L), np.int32)
                        # (1,1) grid + one unmasked patch for empty slots: an
                        # all-masked row would make the attention softmax NaN.
                        masks[:, 0] = 1
                        shapes = np.ones((batch_size, 2), np.int32)
                        for i, item in enumerate(items):
                            if item.pixels is not None:
                                pixels[i] = item.pixels
                                masks[i] = item.mask
                                shapes[i] = item.shape
                                valid[i] = True
                        out_q.put(Batch(pixels=pixels, items=items, valid=valid,
                                        masks=masks, shapes=shapes))
                    else:
                        pixels = np.zeros((batch_size, image_size, image_size, 3), np.uint8)
                        for i, item in enumerate(items):
                            if item.pixels is not None:
                                pixels[i] = item.pixels
                                valid[i] = True
                        out_q.put(Batch(pixels=pixels, items=items, valid=valid))
                    pending.clear()

                for path, last_modified in files:
                    if stop_event.is_set():
                        break
                    pending.append((
                        pool.submit(
                            _decode_one, path, last_modified, image_size,
                            with_hash, naflex, reuse_lookup,
                        ),
                        path, last_modified,
                    ))
                    if len(pending) >= batch_size:
                        flush()
                flush()
            finally:
                pool.shutdown(wait=True)
        except BaseException as e:  # noqa: BLE001 - surface in consumer thread
            error_holder.append(e)
        finally:
            out_q.put(None)

    thread = threading.Thread(target=producer, daemon=True, name="tpuclip-prefetch")
    thread.start()
    try:
        while True:
            batch = out_q.get()
            if batch is None:
                break
            yield batch
        if error_holder:
            raise error_holder[0]
    finally:
        stop_event.set()
        # Drain so the producer can exit if the consumer stopped early. Keep
        # draining while the producer winds down (it may refill the queue
        # from already-submitted decodes), bounded at ~5s like join used to be.
        deadline = 50
        while thread.is_alive() and deadline > 0:
            try:
                out_q.get_nowait()
            except queue.Empty:
                thread.join(timeout=0.1)
                deadline -= 1


def decode_single(path: str, image_size: int) -> Optional[np.ndarray]:
    """One-off decode+resize (search-time image queries)."""
    img = load_image(path)
    if img is None:
        return None
    return resize_to_uint8(img, image_size)
