"""Scan (indexing) pipeline (PyTorch port of ``tpuclip/pipelines/scan.py``).

Behavioral contract from ``scan_directory`` (image_database.py:722-1082):
census → folder grouping (sorted) → sequence sampling → per-folder resume
check → embed → hash → batched idempotent commits; Ctrl-C flushes pending
work and prints resume instructions; ``--limit`` for testing; opt-in
profiling report with images/sec throughput.

Differences from the reference, shared with tpuclip:
- Decode+resize+hash run on a thread pool *ahead of* the device
  (``tpuclip_torch.io.prefetch``), instead of serially inside the embed call.
- Batches are fixed-shape uint8; normalization happens on the device as
  the tower's first op.
- The device embed for batch N is dispatched asynchronously (CUDA kernels
  are queued, not waited for); the host commits batch N-1 to SQLite while
  the device works. The drain's ``.cpu()`` is the barrier.
- NaFlex models take native-aspect patch batches (patches, masks, patch
  grids) from the prefetcher; every batch goes through the model's one
  vision entry (``SiglipModel.image_features``).
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from tpuclip_torch.index.store import connect
from tpuclip_torch.io.prefetch import prefetch_batches
from tpuclip_torch.io.walker import census, group_by_folder, sample_folder_sequences
from tpuclip_torch.utils.logging import banner, log
from tpuclip_torch.utils.profiling import StepTimers


def shard_of_folder(folder: str, num_shards: int) -> int:
    """Deterministic folder→shard assignment for multi-worker indexing."""
    import hashlib

    h = hashlib.md5(str(folder).encode("utf-8")).digest()
    return int.from_bytes(h[:8], "little") % num_shards


def scan_directory(
    engine,
    root_dir: str,
    batch_size: int = 75,
    inference_batch_size: Optional[int] = None,
    profile: bool = False,
    limit: Optional[int] = None,
    exclude_paths: Optional[List[str]] = None,
    save_full_embeddings: bool = True,
    num_shards: int = 1,
    shard_index: int = 0,
    decode_procs: Optional[int] = None,
    reuse_embeddings: bool = False,
    verbose: bool = True,
) -> Optional[dict]:
    """Returns the scan stats dict (processed/skipped/errors/reused/...,
    plus ``interrupted``) so callers like ``--watch`` can react; None when
    the root directory does not exist. ``verbose=False`` silences banners,
    step logs, and the progress bar (error containment still prints) —
    the repeated-rescan mode's quiet passes."""
    try:
        from tqdm import tqdm
    except ImportError:  # pragma: no cover
        tqdm = None

    def vlog(*args, **kwargs):
        if verbose:
            log(*args, **kwargs)

    inference_batch_size = inference_batch_size or engine.inference_batch_size
    engine.inference_batch_size = inference_batch_size

    if verbose:
        banner("Starting Directory Scan")
    vlog(f"Root directory: {root_dir}")
    vlog(f"Database: {engine.db_path}")
    vlog(f"Batch size (DB commits): {batch_size}")
    vlog(f"Inference batch size: {inference_batch_size}")
    if save_full_embeddings:
        vlog("Embedding mode: Full embeddings + Binary embeddings")
    else:
        vlog("Embedding mode: Binary embeddings only (space-efficient mode)")
    if limit:
        vlog(f"Limit: {limit} images (testing mode)")
    vlog("=" * 60 + "\n")

    root_path = Path(root_dir)
    if not root_path.exists():
        log(f"[X] Error: Directory {root_dir} does not exist")
        return None

    if exclude_paths:
        vlog(f"Excluding {len(exclude_paths)} directory path(s):")
        for p in exclude_paths:
            vlog(f"  - {p}")

    vlog("\n[Step 1/4] Counting image files...")
    image_files, excluded_count = census(root_dir, exclude_paths, verbose=verbose)
    if excluded_count:
        vlog(f"  Excluded {excluded_count:,} directories")
    total_found = len(image_files)
    vlog(f"  Found {total_found:,} total image files")

    folders = group_by_folder(image_files)
    vlog(f"  Grouped into {len(folders):,} directories")
    if num_shards > 1:
        # Multi-worker DP indexing: each worker owns a deterministic subset
        # of folders (writing to its own DB; merge with `tpuclip merge`).
        folders = [
            (d, fs) for d, fs in folders if shard_of_folder(str(d), num_shards) == shard_index
        ]
        vlog(f"  Shard {shard_index}/{num_shards}: {len(folders):,} folders assigned")
    if not folders:
        vlog("\n[X] No image files found!")
        return {
            "processed": 0, "skipped": 0, "errors": 0, "sampled_folders": 0,
            "files_removed": 0, "queued": 0, "folders_done": 0, "reused": 0,
            "interrupted": False,
        }

    vlog("\n[Step 2/4] Connecting to database...")
    conn = connect(engine.db_path)
    cursor = conn.cursor()

    timers = StepTimers()
    state = {
        "processed": 0,
        "skipped": 0,
        "errors": 0,
        "sampled_folders": 0,
        "files_removed": 0,
        "queued": 0,
        "folders_done": 0,
        "reused": 0,
        "interrupted": False,
    }
    # "errors" is incremented from both the prefetch producer thread
    # (pending_files) and the main thread (drain); dict += is not atomic.
    errors_lock = threading.Lock()
    db_batch: List[Tuple[str, float, str, np.ndarray]] = []

    vlog("\n[Step 3/4] Processing images...")
    vlog(f"  Processing {len(folders):,} folders...")
    # Progress total = THIS worker's files (post shard filter), not the
    # whole census — with --num-shards the global count would leave the bar
    # stuck at ~1/num_shards forever.
    shard_total = sum(len(fs) for _, fs in folders)
    pbar = (
        tqdm(total=shard_total, desc="Processing images", unit="img", unit_scale=True)
        if tqdm and verbose
        else None
    )

    def pending_files() -> Iterator[Tuple[str, float]]:
        """Yield (path, mtime) for files that still need embedding, folder by
        folder, honoring sampling / resume / limit semantics.

        Runs inside the prefetcher's producer thread, so it opens its own
        SQLite connection for the resume checks (connections are thread-bound;
        WAL allows this read connection alongside the main commit connection —
        same per-operation-connection pattern as image_database.py:850).
        """
        # check_same_thread=False: the connection is used only by this
        # producer thread, but on early exit (Ctrl-C, stop_event) the
        # generator's finally clause may run from whichever thread GCs the
        # suspended generator — a same-thread-checked close would raise.
        check_conn = connect(engine.db_path, check_same_thread=False)
        check_cursor = check_conn.cursor()
        try:
            for parent_dir, folder_files in folders:
                # Files of THIS folder already reflected in stats/pbar (or
                # handed downstream, which accounts for them itself) — the
                # folder-level containment must only count the remainder,
                # not re-count them.
                accounted = 0
                try:
                    state["folders_done"] += 1
                    files_to_process = sample_folder_sequences(sorted(folder_files))
                    removed = len(folder_files) - len(files_to_process)
                    if removed:
                        state["files_removed"] += removed
                        state["sampled_folders"] += 1
                        accounted += removed
                        if pbar:
                            pbar.total = max(pbar.total - removed, pbar.n)

                    folder_metadata = []
                    for img_path in files_to_process:
                        file_path = str(img_path.absolute())
                        try:
                            mtime = os.path.getmtime(file_path)
                        except OSError:
                            # File vanished between census and scan: contain
                            # to the file, not the whole folder.
                            with errors_lock:
                                state["errors"] += 1
                            accounted += 1
                            if pbar:
                                pbar.update(1)
                            continue
                        folder_metadata.append((file_path, mtime))

                    with timers.track("check_db"):
                        processed_files = engine.store.batch_check_processed(
                            check_cursor, folder_metadata
                        )

                    for file_path, last_modified in folder_metadata:
                        if file_path in processed_files:
                            state["skipped"] += 1
                            accounted += 1
                            if pbar:
                                pbar.update(1)
                            continue
                        if limit is not None and state["queued"] >= limit:
                            return
                        state["queued"] += 1
                        accounted += 1
                        yield file_path, last_modified
                except Exception as e:  # noqa: BLE001 - folder containment
                    log(f"\n  [ERROR] Error processing folder {state['folders_done']}: {str(parent_dir)[-80:]}")
                    log(f"  Error: {e}")
                    miss = max(0, len(folder_files) - accounted)
                    with errors_lock:
                        state["errors"] += miss
                    if pbar:
                        pbar.update(miss)
                    continue
        finally:
            check_conn.close()

    def commit(batch) -> None:
        with timers.track("db_write", count=len(batch)):
            engine.store.commit_with_retry(
                cursor, conn, batch, save_full_embeddings,
                thumbnailer=engine.thumbnailer.ensure_for,
            )
        state["processed"] += len(batch)

    # --reuse-embeddings: byte-identical files (same sha256) skip decode AND
    # the device pass, committing the already-indexed embedding under the
    # new path. Covers the common "library reorganized / folders copied"
    # rescan, which the (path, mtime) resume check cannot: a moved file is a
    # new path. Lookup order: this run's recent results (dict, no I/O), then
    # the DB by the idx_images_file_hash index. Called from decode worker
    # THREADS — one shared read connection behind a lock.
    reuse_lookup = None
    reuse_state = {}
    if reuse_embeddings and not save_full_embeddings:
        log(
            "  [WARNING] --reuse-embeddings is ignored with --binary-only: "
            "there is no full embedding row to reuse."
        )
        reuse_embeddings = False
    if reuse_embeddings and save_full_embeddings:
        from tpuclip_torch.io.prefetch import default_procs

        procs = default_procs() if decode_procs is None else decode_procs
        if procs > 0:
            # prefetch would silently drop the lookup (a SQLite-backed
            # closure can't cross the process-pool boundary) while this
            # function kept feeding a never-read run cache.
            log(
                "  [WARNING] --reuse-embeddings is ignored with process-pool "
                "decode (--decode-procs / TPUCLIP_DECODE_PROCS); use thread "
                "decode to reuse embeddings."
            )
            reuse_embeddings = False
    if reuse_embeddings and save_full_embeddings:
        reuse_conn = connect(engine.db_path, check_same_thread=False)
        # The hash index exists only when reuse is used (see
        # store.ensure_hash_index) — build it now, before worker threads
        # start issuing lookups against a full-table scan.
        engine.store.ensure_hash_index(reuse_conn)
        reuse_cursor = reuse_conn.cursor()
        reuse_mutex = threading.Lock()
        run_cache: dict = {}  # sha256 -> np.ndarray, this run's embeddings
        _RUN_CACHE_MAX = 20_000  # ~90 MB at 1152 fp32

        def reuse_lookup(file_hash: str):
            """hash -> (embedding, binary-blob-or-None) or None. Run-cache
            hits from fresh embeds carry blob=None: commit then derives
            sign(vec) from the SAME fp32 vector the source row's commit
            derived from, so the blobs match without caching them; cached
            DB hits keep their fetched blob (exact under lossy stored
            dtypes)."""
            with reuse_mutex:
                hit = run_cache.get(file_hash)
                if hit is not None:
                    return hit
                return engine.store.fetch_embedding_by_hash(reuse_cursor, file_hash)

        def remember(file_hash: str, vec: np.ndarray, blob=None) -> None:
            with reuse_mutex:
                if len(run_cache) >= _RUN_CACHE_MAX:
                    run_cache.clear()  # simple epoch reset; DB backstops misses
                # copy: vec is a row view into the whole (B, D) batch array —
                # caching the view would pin every batch in memory.
                run_cache[file_hash] = (np.array(vec), blob)

        reuse_state = {
            "conn": reuse_conn, "remember": remember, "mutex": reuse_mutex,
        }

    # Opt-in device tracing behind the same --profile flag: the wall-clock
    # timers show host time; a Chrome trace under TPUCLIP_TRACE_DIR shows
    # the device/host overlap, with the timers' steps as spans. Every
    # thread is recorded: check_db runs in the prefetch producer's.
    trace_dir = os.environ.get("TPUCLIP_TRACE_DIR") if profile else None
    tracer = None
    if trace_dir:
        tracer = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]
            + ([torch.profiler.ProfilerActivity.CUDA] if engine.device.type == "cuda" else []),
            experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True),
        )
        tracer.start()

    interrupted = False
    pending_embed = None  # (dispatched embeddings device array, items, valid)
    try:
        def drain(pe):
            """Block on a dispatched embed and stage rows for commit.

            ``emb_dev`` is None for batches where every slot was a reuse hit
            (no device program was dispatched)."""
            emb_dev, items, valid = pe
            emb = None
            if emb_dev is not None:
                # count= only the slots actually embedded: reuse hits and
                # decode failures never touched the device, and counting
                # them would deflate the reported ms/img inference average.
                with timers.track("inference", count=int(np.sum(valid))):
                    emb = emb_dev.cpu().numpy()
            remember = reuse_state.get("remember")
            for i, item in enumerate(items):
                if item.reused_embedding is not None:
                    db_batch.append(
                        (item.path, item.last_modified, item.file_hash,
                         item.reused_embedding, item.reused_binary)
                    )
                    state["reused"] += 1
                    if remember is not None:
                        # Cache DB-fetched hits too: copies 2..N of the same
                        # file become pure dict hits instead of repeating the
                        # SQLite fetch under the shared-connection lock.
                        remember(
                            item.file_hash, item.reused_embedding,
                            item.reused_binary,
                        )
                elif valid[i] and item.file_hash is not None:
                    db_batch.append((item.path, item.last_modified, item.file_hash, emb[i]))
                    if remember is not None:
                        remember(item.file_hash, emb[i])
                else:
                    with errors_lock:
                        state["errors"] += 1
            if pbar:
                pbar.update(len(items))

        naflex_cfg = None
        if engine.is_naflex:
            v = engine.config.vision
            naflex_cfg = (v.patch_size, v.max_num_patches)
        # The prefetcher sets this event itself when the consumer stops early
        # (Ctrl-C, mid-scan failure); without it the producer thread would
        # keep decoding, block forever on its full queue, and leak its SQLite
        # check connection while the generator's join() times out.
        stop_event = threading.Event()
        for batch in prefetch_batches(
            pending_files(),
            batch_size=inference_batch_size,
            image_size=engine.image_size,
            with_hash=True,
            num_procs=decode_procs,
            naflex=naflex_cfg,
            stop_event=stop_event,
            reuse_lookup=reuse_lookup,
        ):
            if not batch.valid.any():
                # Every slot is a reuse hit or a decode failure: nothing for
                # the device to embed — stage rows directly.
                drain((None, batch.items, batch.valid))
                if len(db_batch) >= batch_size:
                    flush, db_batch = db_batch, []
                    commit(flush)
                continue

            # Dispatch this batch (async), then drain the previous one while
            # the device works. Square batches carry no masks or grids.
            host = [x for x in (batch.pixels, batch.masks, batch.shapes) if x is not None]
            inputs = []
            for x in map(torch.from_numpy, host):
                if engine.device.type == "cuda":
                    x = x.pin_memory()
                inputs.append(x.to(engine.device, non_blocking=True))
            emb_dev = engine.model.image_features(*inputs)
            if pending_embed is not None:
                # Clear BEFORE draining: a Ctrl-C landing mid-drain must not
                # let the interrupt handler drain the same batch again
                # (double-staged rows, inflated stats).
                pe, pending_embed = pending_embed, None
                drain(pe)
            pending_embed = (emb_dev[: len(batch.items)], batch.items, batch.valid)

            if len(db_batch) >= batch_size:
                flush, db_batch = db_batch, []
                commit(flush)

        if pending_embed is not None:
            pe, pending_embed = pending_embed, None
            drain(pe)
        if db_batch:
            commit(db_batch)
            db_batch = []

        vlog(f"\n  Processed {state['folders_done']:,} / {len(folders):,} folders")
        if state["sampled_folders"]:
            vlog(
                f"  Sequence sampling: {state['sampled_folders']} folders sampled, "
                f"{state['files_removed']:,} files removed (kept every 100th frame)"
            )
        if limit is not None and state["queued"] >= limit:
            vlog(f"  Limited to {limit} images for testing - stopping")

    except KeyboardInterrupt:
        interrupted = True
        state["interrupted"] = True
        log("\n\nInterrupted! Committing current batch...")
        if pending_embed is not None:
            pe, pending_embed = pending_embed, None
            try:
                drain(pe)
            except Exception:  # noqa: BLE001
                pass
        if db_batch:
            commit(db_batch)
            db_batch = []
        log(
            f"Progress saved: {state['processed']} processed, "
            f"{state['skipped']} skipped, {state['errors']} errors"
        )
        log("You can resume by running the same command - already processed images will be skipped.")
    finally:
        if tracer is not None:
            tracer.stop()
            os.makedirs(trace_dir, exist_ok=True)
            trace_file = os.path.join(trace_dir, "scan_trace.json")
            tracer.export_chrome_trace(trace_file)
            log(f"  Device trace written to {trace_file}")
        if pbar:
            pbar.close()
        if reuse_state.get("conn") is not None:
            # Under the lookup mutex: decode workers may still be mid-query
            # on this shared connection when an early exit lands here (the
            # prefetch shutdown join is time-bounded).
            with reuse_state["mutex"]:
                reuse_state["conn"].close()
        conn.close()

    if not interrupted:
        vlog("\n[Step 4/4] Finalizing...")
        if verbose:
            banner("Scan Complete!")
        vlog(f"  Processed: {state['processed']:,} images")
        if state["reused"]:
            vlog(
                f"  Reused: {state['reused']:,} embeddings "
                "(byte-identical files, decode+embed skipped)"
            )
        vlog(f"  Skipped: {state['skipped']:,} images (already in database)")
        vlog(f"  Errors: {state['errors']:,}" if state["errors"] else "  Errors: 0")
        if profile:
            timers.report(processed=state["processed"])
        vlog("=" * 60 + "\n")
    return state
