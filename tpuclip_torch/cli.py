"""Command-line interface of the PyTorch port.

Every subcommand of ``tpuclip`` (tpuclip/cli.py) with the same flags,
messages and exit codes: ``scan``, ``search`` (a single query, or the
interactive session and its mini-language), ``serve``, ``info``, ``gc``,
``check``, ``prune``, ``migrate``, ``export``, ``merge``, ``duplicates``,
``convert``, ``classify``, ``selftest`` and ``train``. Those that run a
model take ``--device {cuda,cpu}`` (default ``cuda``; the CPU only when
named). Usage::

    python -m tpuclip_torch.cli scan DIR --db photos.db
    python -m tpuclip_torch.cli search "a red car" -k 20 --db photos.db
    python -m tpuclip_torch.cli serve --db photos.db --port 8000 --warm
    python -m tpuclip_torch.cli info --db photos.db
    python -m tpuclip_torch.cli train captions/ --output finetuned --steps 100
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

from tpuclip_torch.config import default_paths, list_db_files, resolve_db_path
from tpuclip_torch.utils.logging import is_tty, log


# =============================================================================
# Interactive-line grammar (pure)
# =============================================================================


@dataclass
class SearchSpec:
    query: str
    is_image: bool = False
    query2: Optional[str] = None
    is_image2: bool = False
    negative_query: Optional[str] = None
    negative_is_image: bool = False
    negative_queries: Optional[List[str]] = None
    negative_is_images: Optional[List[bool]] = None
    negative_weights: Optional[List[float]] = None


@dataclass
class ReplCommand:
    kind: str  # quit | empty | set_k | folder | folder_clear | duplicates | search | error
    k: Optional[int] = None
    folder: Optional[str] = None
    show_duplicates: Optional[bool] = None
    search: Optional[SearchSpec] = None
    message: str = ""


def _strip_image_prefix(part: str) -> Tuple[str, bool]:
    if part.lower().startswith("image:"):
        return part.split(":", 1)[1].strip(), True
    return part, False


def parse_interactive_line(
    line: str,
    default_negative_weight: float = 0.5,
    preset: Optional[SearchSpec] = None,
) -> ReplCommand:
    """Parse one REPL line into a command (image_database.py:2105-2239).

    ``preset`` carries CLI-provided fields for the *first* session query
    (image_database.py:2072-2087): a CLI ``--negative`` suppresses ``' - '``
    parsing and a CLI ``--query2`` suppresses ``'+'``/``image:`` parsing —
    exactly the reference's "if not already set from command line" guards
    (:2157, :2193).
    """
    query = line.strip()
    if not query:
        return ReplCommand("empty")
    if query.lower() in ("quit", "exit", "q"):
        return ReplCommand("quit")
    if query.lower().startswith("k:"):
        try:
            k = int(query.split(":", 1)[1].strip())
        except ValueError:
            return ReplCommand("error", message="Invalid number. Usage: k:20")
        if k < 1:
            # The reference accepts 0/negatives (its SQL LIMIT just returns
            # nothing); here a negative k would error the device top-k on
            # every subsequent search — reject it upfront.
            return ReplCommand("error", message="k must be >= 1. Usage: k:20")
        return ReplCommand("set_k", k=k)
    if query.lower().startswith("folder:"):
        folder_path = query.split(":", 1)[1].strip()
        if folder_path.lower() == "clear":
            return ReplCommand("folder_clear")
        return ReplCommand("folder", folder=folder_path)
    if query.lower().startswith("duplicates:"):
        setting = query.split(":", 1)[1].strip().lower()
        if setting == "show":
            return ReplCommand("duplicates", show_duplicates=True)
        if setting == "hide":
            return ReplCommand("duplicates", show_duplicates=False)
        return ReplCommand(
            "error", message="Invalid option. Use 'duplicates:show' or 'duplicates:hide'"
        )

    if preset is not None:
        spec = SearchSpec(
            query=query,
            is_image=preset.is_image,
            query2=preset.query2,
            is_image2=preset.is_image2,
            negative_query=preset.negative_query,
            negative_is_image=preset.negative_is_image,
        )
    else:
        spec = SearchSpec(query=query)

    # Negatives: "<query> - <neg1> - <neg2> ..." (split precedes '+' parsing,
    # image_database.py:2156-2190); skipped when the CLI already set one.
    if spec.negative_query is None and not spec.is_image and " - " in spec.query:
        head, negative_str = spec.query.split(" - ", 1)
        spec.query = head.strip()
        negative_parts = [p.strip() for p in negative_str.strip().split(" - ")]
        if len(negative_parts) == 1:
            neg, is_img = _strip_image_prefix(negative_parts[0])
            spec.negative_query = neg
            spec.negative_is_image = is_img
        else:
            qs, flags = [], []
            for part in negative_parts:
                neg, is_img = _strip_image_prefix(part)
                qs.append(neg)
                flags.append(is_img)
            spec.negative_queries = qs
            spec.negative_is_images = flags
            spec.negative_weights = [default_negative_weight] * len(qs)

    # Combined: "q1 + q2" (split on '+', image_database.py:2192-2213);
    # skipped when the CLI already set --query2, or marked the query as an
    # image path with --image (a path must not be split or prefix-stripped).
    if spec.query2 is None and not spec.is_image:
        query_parts = [q.strip() for q in spec.query.split("+", 1)]
        if len(query_parts) == 2:
            q1, is1 = _strip_image_prefix(query_parts[0])
            q2, is2 = _strip_image_prefix(query_parts[1])
            spec.query, spec.is_image = q1, is1
            spec.query2, spec.is_image2 = q2, is2
        else:
            q1, is1 = _strip_image_prefix(spec.query)
            if is1:
                spec.query, spec.is_image = q1, is1
            # No prefix found: keep spec.is_image as-is so a CLI --image
            # preset is not clobbered (plain lines default to False anyway).

    return ReplCommand("search", search=spec)


def display_query_string(spec: SearchSpec) -> str:
    """Query string shown in galleries (image_database.py:2270-2277)."""
    display = spec.query
    if spec.query2:
        display += f" + {spec.query2}"
    if spec.negative_queries:
        display += " - " + " - ".join(spec.negative_queries)
    elif spec.negative_query:
        display += f" - {spec.negative_query}"
    return display


# =============================================================================
# Argument parser
# =============================================================================


def build_parser() -> argparse.ArgumentParser:
    paths = default_paths()
    parser = argparse.ArgumentParser(
        prog="tpuclip_torch",
        description="Searchable Image Database using SigLIP 2 (PyTorch / CUDA port)",
    )
    subparsers = parser.add_subparsers(dest="mode", help="Mode to run")

    scan_parser = subparsers.add_parser("scan", help="Scan directory and process images")
    scan_parser.add_argument("directory", help="Root directory to scan")
    scan_parser.add_argument("--db", default=None, help="Database path (required unless using --db-name)")
    scan_parser.add_argument("--db-name", default=None, help=f"Database filename in {paths.db_dir} (e.g. products_database.db)")
    scan_parser.add_argument("--batch-size", type=int, default=75, help="Batch size for DB commits")
    scan_parser.add_argument("--inference-batch-size", type=int, default=16, help="Batch size for model inference (higher = faster but more device memory)")
    scan_parser.add_argument("--profile", action="store_true", help="Show performance profiling information")
    scan_parser.add_argument("--limit", type=int, default=None, help="Limit number of images to process (for testing)")
    scan_parser.add_argument("--model-cache", default=paths.model_cache_dir, help="Model cache directory")
    scan_parser.add_argument("--exclude", action="append", help="Exclude directory path (can be used multiple times)")
    scan_parser.add_argument("--binary-only", action="store_true", help="Only save binary embeddings (space-efficient mode)")
    scan_parser.add_argument("--fp16-vectors", action="store_true", help="Store full vectors as fp16 blobs (half the DB size; search re-ranks against fp32)")
    scan_parser.add_argument("--int8-vectors", action="store_true", help="Store full vectors as per-vector symmetric int8 (quarter the DB size; exact rescore then runs at int8 precision)")
    scan_parser.add_argument("--model", default=None, help="Model preset name (default: google/siglip2-so400m-patch14-224)")
    scan_parser.add_argument(
        "--fast-decode", action="store_true",
        help="JPEG DCT-domain fast decode (3-8x faster on large photos; "
        "pixels differ slightly from a full decode)",
    )
    scan_parser.add_argument("--decode-procs", type=int, default=None, help="Decode in N worker processes instead of threads (for many-core hosts where Python overhead caps the thread pool)")
    scan_parser.add_argument("--reuse-embeddings", action="store_true", help="Skip decode+embed for byte-identical files already indexed (same sha256): moved/copied libraries rescan at hash speed. Thread-pool decode only; needs full embeddings in the DB")
    scan_parser.add_argument(
        "--watch", nargs="?", const=30.0, type=float, default=None,
        metavar="SECONDS",
        help="After the scan, keep watching the tree: rescan every SECONDS "
        "(default 30) and index new/changed files incrementally. A serve "
        "process on the same DB picks the rows up on its next query "
        "(WAL read-during-write). Ctrl-C stops.",
    )
    scan_parser.add_argument("--num-shards", type=int, default=1, help="Multi-worker indexing: total workers")
    scan_parser.add_argument("--shard-index", type=int, default=0, help="Multi-worker indexing: this worker's shard")

    search_parser = subparsers.add_parser("search", help="Search for similar images")
    search_parser.add_argument("query", nargs="?", help="Text query or image file path (optional if using --interactive)")
    search_parser.add_argument("-k", type=int, default=10, help="Number of results")
    search_parser.add_argument("--image", action="store_true", help="Treat query as image file path")
    search_parser.add_argument("--query2", help="Second query for combined search (text or image path)")
    search_parser.add_argument("--image2", action="store_true", help="Treat query2 as image file path")
    search_parser.add_argument("--weights", nargs=2, type=float, default=[0.5, 0.5], metavar=("W1", "W2"), help="Weights for combining queries (default: 0.5 0.5)")
    search_parser.add_argument("--negative", help="Negative prompt to exclude (text or image path)")
    search_parser.add_argument("--negative-image", action="store_true", help="Treat negative prompt as image file path")
    search_parser.add_argument("--negative-weight", type=float, default=0.5, help="Weight for negative prompt subtraction (default: 0.5)")
    search_parser.add_argument("--db", default=None, help="Database path (required unless using --db-name)")
    search_parser.add_argument("--db-name", default=None, help=f"Database filename in {paths.db_dir} (e.g. photos_database.db)")
    search_parser.add_argument("--model-cache", default=paths.model_cache_dir, help="Model cache directory")
    search_parser.add_argument("--output", default=None, help="Output HTML file (default: derived from the query under the results dir)")
    search_parser.add_argument("--interactive", "-i", action="store_true", help="Interactive session mode (default when query provided)")
    search_parser.add_argument("--no-session", action="store_true", help="Exit after processing query instead of keeping session open")
    search_parser.add_argument("--folder", action="append", help="Filter results to images in this folder (repeatable)")
    search_parser.add_argument("--profile", action="store_true", help="Show performance profiling information for search")
    search_parser.add_argument("--show-duplicates", action="store_true", help="Show duplicate images in results (default: filtered)")
    search_parser.add_argument("--model", default=None, help="Model preset name (default: google/siglip2-so400m-patch14-224)")
    search_parser.add_argument("--precision", choices=["bf16", "int8"], default=None, help="Search precision: int8 quantized scan with exact re-rank (the default) or the plain bf16 scan")
    search_parser.add_argument("--mode", dest="search_mode", choices=["exact", "ivf", "cascade"], default=None, help="Search mode: exact scan (default), ivf (k-means buckets on the device, nprobe 32 of ~2*sqrt(N), int8 probe + exact rescore against the resident rows; needs the rerank rows on the device and >= 64 rows), or cascade (packed-binary prefilter + exact fp32 rescore from the host; no flat matrix on the device)")

    # Beyond the reference surface: checkpoint conversion + fine-tuning.
    convert_parser = subparsers.add_parser(
        "convert", help="Convert an HF-layout checkpoint to the tpuclip-native format"
    )
    convert_parser.add_argument("src", help="Source checkpoint directory (HF layout) or model name in the cache")
    convert_parser.add_argument("dst", help="Destination directory for the tpuclip checkpoint")
    convert_parser.add_argument("--model-cache", default=paths.model_cache_dir, help="Model cache directory for name lookups")

    train_parser = subparsers.add_parser(
        "train", help="Contrastive fine-tuning on (image, sidecar-caption) pairs"
    )
    train_parser.add_argument("data", help="Directory of images with sidecar .txt captions")
    train_parser.add_argument("--output", required=True, help="Output directory for checkpoints")
    train_parser.add_argument("--model", default=None, help="Model preset name")
    train_parser.add_argument("--model-cache", default=paths.model_cache_dir, help="Model cache directory")
    train_parser.add_argument("--steps", type=int, default=100, help="Training steps")
    train_parser.add_argument("--batch-size", type=int, default=16, help="Global batch size")
    train_parser.add_argument("--lr", type=float, default=1e-5, help="Learning rate")
    train_parser.add_argument("--resume", default=None, help="Train-state directory to resume from (a train_state/ this port wrote: train_state.pt, torch.save; tpuclip's orbax directories are refused)")
    train_parser.add_argument("--seed", type=int, default=0, help="Shuffle seed")
    train_parser.add_argument("--optimizer", choices=["auto", "adamw", "adafactor"], default="auto", help="auto = AdamW, switching to Adafactor when the AdamW state would not fit the device")

    serve_parser = subparsers.add_parser(
        "serve", help="HTTP search server (resident model + device index)"
    )
    serve_parser.add_argument("--db", default=None, help="Database path")
    serve_parser.add_argument("--db-name", default=None, help=f"Database filename in {paths.db_dir}")
    serve_parser.add_argument("--host", default="127.0.0.1", help="Bind host")
    serve_parser.add_argument("--port", type=int, default=8000, help="Bind port")
    serve_parser.add_argument("--model", default=None, help="Model preset name")
    serve_parser.add_argument("--model-cache", default=paths.model_cache_dir, help="Model cache directory")
    serve_parser.add_argument("--precision", choices=["bf16", "int8"], default=None, help="Search precision")
    serve_parser.add_argument("--mode", dest="search_mode", choices=["exact", "ivf", "cascade"], default=None, help="Search mode (see search --mode)")
    serve_parser.add_argument("--warm", action="store_true", help="Capture the full serving program matrix (every batch-bucket combination, one CUDA graph each) before accepting traffic, so no live window pays a capture")

    merge_parser = subparsers.add_parser(
        "merge", help="Merge shard databases (from sharded scans) into one"
    )
    merge_parser.add_argument("dst", help="Destination database path")
    merge_parser.add_argument("srcs", nargs="+", help="Source shard database paths")

    dup_parser = subparsers.add_parser(
        "duplicates", help="Find all near-duplicate clusters in a database"
    )
    dup_parser.add_argument("--db", default=None, help="Database path")
    dup_parser.add_argument("--db-name", default=None, help=f"Database filename in {paths.db_dir}")
    dup_parser.add_argument("--tolerance", type=int, default=2, help="Hamming tolerance in bits (default: 2)")

    classify_parser = subparsers.add_parser(
        "classify", help="Zero-shot classification of one image against labels"
    )
    classify_parser.add_argument("image", help="Image file path")
    classify_parser.add_argument("--labels", required=True, help="Comma-separated label list")
    classify_parser.add_argument("--model", default=None, help="Model preset name")
    classify_parser.add_argument("--model-cache", default=paths.model_cache_dir, help="Model cache directory")

    info_parser = subparsers.add_parser("info", help="Show database summary (no model load)")
    info_parser.add_argument("--db", default=None, help="Database path")
    info_parser.add_argument("--db-name", default=None, help=f"Database filename in {paths.db_dir}")

    gc_parser = subparsers.add_parser(
        "gc", help="Remove orphaned thumbnails (hashes no database references)"
    )
    gc_parser.add_argument("--db", action="append", default=None, help="Database path to keep referenced (repeatable; default: every .db in the databases dir)")
    gc_parser.add_argument("--dry-run", action="store_true", help="Report what would be removed without deleting")
    gc_parser.add_argument("--decode-cache", default=None, metavar="DIR", help="Also bound the decode cache at DIR (default: $TPUCLIP_DECODE_CACHE when set)")
    gc_parser.add_argument("--decode-cache-max-gb", type=float, default=None, help="Evict oldest decode-cache entries until under this size (omit to just report the size)")

    check_parser = subparsers.add_parser(
        "check",
        help="Verify database integrity: orphans, blob shapes, bad vectors "
        "(no model load); exits 1 on problems",
    )
    check_parser.add_argument("--db", default=None, help="Database path")
    check_parser.add_argument("--db-name", default=None, help=f"Database filename in {paths.db_dir}")
    check_parser.add_argument("--fix", action="store_true", help="Delete rows a rescan can rebuild (orphaned/undecodable embeddings); never touches the images table")

    prune_parser = subparsers.add_parser(
        "prune",
        help="Remove rows whose files no longer exist on disk (no model load)",
    )
    prune_parser.add_argument("--db", default=None, help="Database path")
    prune_parser.add_argument("--db-name", default=None, help=f"Database filename in {paths.db_dir}")
    prune_parser.add_argument("--folder", action="append", default=None, help="Only check paths under this directory (repeatable)")
    prune_parser.add_argument("--dry-run", action="store_true", help="Report what would be removed without deleting")

    migrate_parser = subparsers.add_parser(
        "migrate",
        help="Migrate a reference-built DB (sqlite-vec vec0) to tpuclip's "
        "embedding layout, in place",
    )
    migrate_parser.add_argument("--db", default=None, help="Database path")
    migrate_parser.add_argument("--db-name", default=None, help=f"Database filename in {paths.db_dir}")
    migrate_parser.add_argument("--dry-run", action="store_true", help="Report what would be migrated without writing")

    selftest_parser = subparsers.add_parser(
        "selftest",
        help="Real-checkpoint bring-up drill: locate/download, convert, "
        "load, tokenizer golden check, HF parity spot check (exit 1 on any "
        "failure)",
    )
    selftest_parser.add_argument(
        "--real-checkpoint", action="store_true",
        help="Run against the real pretrained checkpoint (the flag documents "
        "intent; checkpoint steps run by default)",
    )
    selftest_parser.add_argument(
        "--e2e", action="store_true",
        help="Also run the full product smoke: scan a bundled ~20-image tree "
        "into a temp DB, text + image: searches (self-retrieval), duplicate "
        "filter, gallery, and DB integrity check",
    )
    selftest_parser.add_argument(
        "--e2e-only", action="store_true",
        help="Run only the product smoke (skip the checkpoint bring-up steps)",
    )
    selftest_parser.add_argument("--model", default=None, help="Model name (default: the engine default model)")
    selftest_parser.add_argument("--source", default=None, help="Local HF-layout checkpoint directory (skips cache lookup and download)")
    selftest_parser.add_argument("--model-cache", default=paths.model_cache_dir, help="Model cache directory")
    selftest_parser.add_argument("--no-download", action="store_true", help="Never attempt a network download")
    selftest_parser.add_argument("--parity-bound", type=float, default=None, help="Min acceptable cosine vs the HF oracle (default 0.999)")
    selftest_parser.add_argument("--skip-parity", action="store_true", help="Skip the HF/PyTorch forward parity step")
    selftest_parser.add_argument("--convert-to", default=None, help="Directory for the converted tpuclip-native checkpoint (default: <model-cache>/tpuclip--<name>)")

    export_parser = subparsers.add_parser(
        "export", help="Export embeddings to npz/npy/jsonl for external tooling (no model load)"
    )
    export_parser.add_argument("output", help="Output file path")
    export_parser.add_argument("--db", default=None, help="Database path")
    export_parser.add_argument("--db-name", default=None, help=f"Database filename in {paths.db_dir}")
    export_parser.add_argument("--format", default=None, choices=["npz", "npy", "jsonl"], help="Output format (default: inferred from the output extension, else npz)")
    export_parser.add_argument("--binary", action="store_true", help="Also export the binary (sign-bit) embeddings (npz only)")

    for sub in (scan_parser, search_parser, serve_parser, classify_parser, selftest_parser, train_parser):
        sub.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help="Device for the towers and the index (default: cuda)")
    return parser


def _require_db_path(args, paths) -> str:
    try:
        return resolve_db_path(args.db, getattr(args, "db_name", None), paths.db_dir)
    except ValueError:
        log("\n[X] Error: No database selected.")
        log("Please specify either:")
        log('  --db "/data/image-databases/products_database.db"')
        log("  --db-name products_database.db")
        log(f"\nDatabase directory: {paths.db_dir}")
        dbs = list_db_files(paths.db_dir)
        if dbs:
            log("Available .db files:")
            for name in dbs:
                log(f"  - {name}")
        else:
            log("No .db files found in database directory.")
        sys.exit(2)


def _require_existing_db_path(args, paths) -> str:
    """_require_db_path + existence check with the shared error contract."""
    db_path = _require_db_path(args, paths)
    if not os.path.exists(db_path):
        log(f"[X] Error: Database file does not exist: {db_path}")
        sys.exit(2)
    return db_path


def _model_name(args) -> str:
    from tpuclip_torch.models.configs import DEFAULT_MODEL

    return args.model or os.environ.get("TPUCLIP_MODEL", DEFAULT_MODEL)


def _make_engine(db_path: str, args):
    from tpuclip_torch.engine import ImageDatabase

    if getattr(args, "precision", None):
        os.environ["TPUCLIP_SEARCH_PRECISION"] = args.precision
    # dest is search_mode: "mode" already carries the subcommand name
    if getattr(args, "search_mode", None):
        os.environ["TPUCLIP_SEARCH_MODE"] = args.search_mode
    return ImageDatabase(
        db_path,
        args.model_cache or None,
        model_name=_model_name(args),
        inference_batch_size=getattr(args, "inference_batch_size", 16),
        device=args.device,
    )


def _run_scan(args, paths) -> None:
    log("Starting scan mode...\n")
    if getattr(args, "fast_decode", False):
        os.environ["TPUCLIP_FAST_DECODE"] = "1"
    if getattr(args, "fp16_vectors", False):
        os.environ["TPUCLIP_VECTOR_DTYPE"] = "fp16"
    if getattr(args, "int8_vectors", False):
        if getattr(args, "fp16_vectors", False):
            log("Error: --fp16-vectors and --int8-vectors are mutually exclusive")
            sys.exit(1)
        os.environ["TPUCLIP_VECTOR_DTYPE"] = "int8"
    db_path = _require_db_path(args, paths)
    log("Initializing database connection and loading model...")
    db = _make_engine(db_path, args)
    log("\nStarting directory scan...\n")

    def one_pass(verbose: bool = True):
        return db.scan_directory(
            args.directory,
            batch_size=args.batch_size,
            inference_batch_size=args.inference_batch_size,
            profile=args.profile and verbose,
            limit=args.limit,
            exclude_paths=args.exclude if args.exclude else None,
            save_full_embeddings=not args.binary_only,
            num_shards=args.num_shards,
            shard_index=args.shard_index,
            decode_procs=args.decode_procs,
            reuse_embeddings=args.reuse_embeddings,
            verbose=verbose,
        )

    state = one_pass()
    if getattr(args, "watch", None) is None or state is None:
        return
    if state.get("interrupted"):
        return

    import time as _time

    interval = max(1.0, float(args.watch))
    log(f"\nWatching {args.directory}: rescanning every {interval:g}s (Ctrl-C to stop)")
    # Test hook: bound the loop so the watch path is drivable in CI.
    max_loops = int(os.environ.get("TPUCLIP_WATCH_MAX_LOOPS", "0") or 0)
    loops = 0
    while True:
        try:
            _time.sleep(interval)
        except KeyboardInterrupt:
            log("\nWatch stopped.")
            return
        state = one_pass(verbose=False)
        if state is None or state.get("interrupted"):
            log("\nWatch stopped.")
            return
        if state["processed"] or state["reused"] or state["errors"]:
            log(
                f"  [watch {_time.strftime('%H:%M:%S')}] indexed "
                f"{state['processed'] + state['reused']:,} new images"
                + (f", {state['errors']} errors" if state["errors"] else "")
            )
        loops += 1
        if max_loops and loops >= max_loops:
            return


def _print_results(results) -> None:
    log(f"\nFound {len(results)} results:")
    for i, (file_path, similarity) in enumerate(results, 1):
        log(f"  {i:2d}. {similarity:.4f}: {file_path}")


def _run_search(args, paths) -> None:
    from tpuclip_torch.gallery.html import (
        combined_output_filename,
        generate_output_filename,
    )

    log("Starting search mode...\n")
    db_path = _require_db_path(args, paths)

    if not os.path.exists(db_path):
        log(f"\n[X] Error: Database file does not exist: {db_path}")
        log(f"\nDatabase directory: {paths.db_dir}")
        dbs = list_db_files(paths.db_dir)
        if dbs:
            log("Available .db files:")
            for name in dbs:
                log(f"  - {name}")
        else:
            log("No .db files found in database directory.")
        sys.exit(2)

    # Schema pre-flight: images table must exist (image_database.py:2004-2016).
    import sqlite3

    try:
        conn_check = sqlite3.connect(db_path)
        cur = conn_check.cursor()
        cur.execute("SELECT name FROM sqlite_master WHERE type='table' AND name='images'")
        ok = cur.fetchone()
        conn_check.close()
        if not ok:
            log(f"\n[X] Error: Database file exists but does not contain the expected schema: {db_path}")
            log("The database appears to be empty or not a valid image database.")
            sys.exit(2)
    except sqlite3.Error as e:
        log(f"\n[X] Error: Could not verify database schema: {e}")
        sys.exit(2)

    log("Initializing database connection and loading model...")
    db = _make_engine(db_path, args)

    if args.interactive or (args.query is not None and not args.no_session):
        _interactive_session(db, args)
        return

    # Single-shot mode (image_database.py:2300-2362)
    if not args.query:
        log("Error: Query required (or use --interactive for session mode)")
        return

    if args.query2:
        log("Combined search:")
        log(f"  Query 1: {args.query} ({'image' if args.image else 'text'})")
        log(f"  Query 2: {args.query2} ({'image' if args.image2 else 'text'})")
        log(f"  Weights: {args.weights[0]:.1f} / {args.weights[1]:.1f}")
    if args.negative:
        log(f"  Negative: {args.negative} ({'image' if args.negative_image else 'text'})")

    try:
        results = db.search(
            args.query, k=args.k, is_image_path=args.image,
            query2=args.query2, is_image_path2=args.image2,
            weights=tuple(args.weights),
            negative_query=args.negative, negative_is_image=args.negative_image,
            negative_weight=args.negative_weight,
            filter_folders=args.folder if args.folder else None,
            profile=args.profile,
            show_duplicates=args.show_duplicates,
        )
    except ValueError as e:  # a text query to a model without a text tower
        log(f"[X] Error: {e}")
        sys.exit(2)
    if not results:
        log("No results found.")
        return

    log(f"\nFound {len(results)} results:")
    for file_path, similarity in results:
        log(f"  {similarity:.4f}: {file_path}")

    if args.output is None:  # no explicit --output → derive from query
        if args.query2:
            output_file = combined_output_filename(
                args.query, args.query2, args.image, args.image2,
                results_dir=Path(db.results_dir),
            )
        else:
            output_file = generate_output_filename(
                args.query, args.image, results_dir=Path(db.results_dir)
            )
    else:
        output_file = args.output

    display_query = display_query_string(
        SearchSpec(query=args.query, query2=args.query2, negative_query=args.negative)
    )
    db.generate_html_gallery(results, output_file, query=display_query)
    log(f"\nResults saved to {output_file}")


def _interactive_session(db, args) -> None:
    """The search session (image_database.py:2026-2299): one engine, so the
    towers load once and the index uploads once unless the database
    changes. On a non-tty stdin it runs the CLI query and returns."""
    from tpuclip_torch.gallery.html import generate_output_filename

    log("\n" + "=" * 60)
    log("Interactive Search Session")
    log("=" * 60)
    if args.query:
        log("Processing initial query, then session will remain open for more queries...")
    else:
        log("Model loaded and ready! Enter queries below.")
    log("Commands:")
    log("  - Enter a text query to search")
    log("  - Type 'image:<path>' to search by image")
    log("  - Type 'image:<path1> + image:<path2>' for combined image search")
    log("  - Type 'image:<path> + <text>' or '<text> + image:<path>' for image+text search")
    log("  - Type '<query> - <negative>' to exclude concepts")
    log("  - Type '<query> - <neg1> - <neg2>' for multiple negatives")
    log("  - Type 'k:<number>' to change number of results (default: 10)")
    log("  - Type 'folder:<path>' to filter results to a folder (can use multiple times)")
    log("  - Type 'folder:clear' to clear folder filters")
    log("  - Type 'duplicates:show' to show duplicate images (default: hidden)")
    log("  - Type 'duplicates:hide' to hide duplicate images (default)")
    log("  - Type 'quit' or 'exit' to end session")
    log("=" * 60 + "\n")

    current_k = args.k
    weights = tuple(args.weights)
    filter_folders: List[str] = list(args.folder) if args.folder else []
    show_duplicates = args.show_duplicates
    negative_weight = args.negative_weight
    interactive = is_tty()

    first_cli_query = args.query
    # An explicit --output applies to the CLI-provided query's gallery;
    # subsequent interactive queries derive their own filenames.
    cli_output: Optional[str] = args.output if args.query else None

    while True:
        try:
            output_override = None
            if first_cli_query is not None:
                # The first iteration takes the CLI query and its modifiers;
                # the mini-language still applies to what the CLI did not set.
                preset = SearchSpec(
                    query=first_cli_query,
                    is_image=args.image,
                    query2=args.query2,
                    is_image2=args.image2,
                    negative_query=args.negative,
                    negative_is_image=args.negative_image,
                )
                cmd = parse_interactive_line(first_cli_query, negative_weight, preset=preset)
                first_cli_query = None
                if cmd.kind == "search":
                    # --output belongs to this query only: a first query that
                    # fails must not hand it to a later interactive query.
                    output_override, cli_output = cli_output, None
            else:
                if not interactive:
                    break
                line = input("Query> ")
                cmd = parse_interactive_line(line, negative_weight)
            # Session commands apply to the CLI-provided first line too.
            if cmd.kind == "empty":
                continue
            if cmd.kind == "quit":
                log("Ending session. Goodbye!")
                break
            if cmd.kind == "error":
                log(cmd.message)
                continue
            if cmd.kind == "set_k":
                current_k = cmd.k
                log(f"Number of results set to {current_k}")
                continue
            if cmd.kind == "folder_clear":
                filter_folders = []
                log("Folder filters cleared")
                continue
            if cmd.kind == "folder":
                folder_abs = os.path.abspath(cmd.folder)
                if os.path.isdir(folder_abs):
                    if folder_abs not in filter_folders:
                        filter_folders.append(folder_abs)
                        log(f"Added folder filter: {folder_abs}")
                    else:
                        log(f"Folder already in filter list: {folder_abs}")
                else:
                    log(f"Warning: Folder does not exist: {folder_abs}")
                if filter_folders:
                    log(f"Current folder filters ({len(filter_folders)}):")
                    for f in filter_folders:
                        log(f"  - {f}")
                continue
            if cmd.kind == "duplicates":
                show_duplicates = cmd.show_duplicates
                log(
                    "Duplicate images will be shown"
                    if show_duplicates
                    else "Duplicate images will be hidden (default)"
                )
                continue
            spec = cmd.search

            # Echo the parsed query (image_database.py:2215-2250)
            if spec.query2:
                log("\nCombined search:")
                log(f"  Query 1: {spec.query} ({'image' if spec.is_image else 'text'})")
                log(f"  Query 2: {spec.query2} ({'image' if spec.is_image2 else 'text'})")
                log(f"  Weights: {weights[0]:.1f} / {weights[1]:.1f}")
            else:
                log(f"\nSearching for: {spec.query}")
            if spec.negative_queries:
                log(f"  Negatives ({len(spec.negative_queries)}): {', '.join(spec.negative_queries)}")
            elif spec.negative_query:
                log(f"  Negative: {spec.negative_query} ({'image' if spec.negative_is_image else 'text'})")
            log(f"  Number of results: {current_k}")

            results = db.search(
                spec.query, k=current_k, is_image_path=spec.is_image,
                query2=spec.query2, is_image_path2=spec.is_image2,
                weights=weights,
                negative_query=spec.negative_query,
                negative_is_image=spec.negative_is_image,
                negative_weight=negative_weight,
                negative_queries=spec.negative_queries,
                negative_is_images=spec.negative_is_images,
                negative_weights=spec.negative_weights,
                filter_folders=filter_folders if filter_folders else None,
                profile=args.profile,
                show_duplicates=show_duplicates,
            )

            if results:
                _print_results(results)
                if output_override:
                    output_file = output_override
                else:
                    output_file = generate_output_filename(
                        spec.query, spec.is_image, results_dir=Path(db.results_dir)
                    )
                db.generate_html_gallery(
                    results, output_file, query=display_query_string(spec)
                )
                log(f"\nResults saved to {output_file}")
            else:
                log("No results found.")

            if not interactive:
                break
            log("")
        except KeyboardInterrupt:
            log("\n\nInterrupted. Ending session.")
            break
        except EOFError:
            if interactive:
                log("\nEnding session. Goodbye!")
            break
        except Exception as e:  # noqa: BLE001 - the session must survive errors
            log(f"Error: {e}")
            continue


def main(argv: Optional[List[str]] = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    paths = default_paths()
    if args.mode == "scan":
        _run_scan(args, paths)
    elif args.mode == "search":
        _run_search(args, paths)
    elif args.mode == "convert":
        _run_convert(args)
    elif args.mode == "serve":
        from tpuclip_torch.serve import run_serve

        run_serve(args, paths)
    elif args.mode == "merge":
        from tpuclip_torch.pipelines.merge import merge_databases

        merge_databases(args.dst, args.srcs)
    elif args.mode == "classify":
        from tpuclip_torch.pipelines.classify import run_classify

        labels = [l.strip() for l in args.labels.split(",") if l.strip()]
        if not labels:
            log("[X] Error: --labels must contain at least one label")
            sys.exit(2)
        run_classify(
            args.image, labels,
            model_name=_model_name(args),
            model_cache_dir=args.model_cache or None,
            device=args.device,
        )
    elif args.mode == "selftest":
        from tpuclip_torch.selftest import (
            DEFAULT_PARITY_BOUND,
            SelftestReport,
            run_e2e_selftest,
            run_selftest,
        )

        model_name = _model_name(args)
        cache = args.model_cache or None
        report = SelftestReport()
        if not args.e2e_only:
            report = run_selftest(
                model_name=model_name,
                model_cache_dir=cache,
                source=args.source,
                allow_download=not args.no_download,
                parity_bound=(
                    args.parity_bound if args.parity_bound is not None
                    else DEFAULT_PARITY_BOUND
                ),
                skip_parity=args.skip_parity,
                convert_dst=args.convert_to,
                device=args.device,
            )
        if args.e2e or args.e2e_only:
            run_e2e_selftest(model_name, cache, report=report, source=args.source,
                             device=args.device)
        if not report.ok:
            sys.exit(1)
    elif args.mode == "info":
        _run_info(args, paths)
    elif args.mode == "gc":
        _run_gc(args, paths)
    elif args.mode == "check":
        from tpuclip_torch.pipelines.check import check_database

        db_path = _require_existing_db_path(args, paths)
        result = check_database(db_path, fix=args.fix)
        if not result.ok:
            if args.fix and result.fixed:
                # Deletions applied: the exit code reflects the DB's state
                # now, so `check --fix && scan` scripts work.
                if check_database(db_path, verbose=False).ok:
                    log("Database OK after fix.")
                else:
                    log("[X] Problems remain after fix.")
                    sys.exit(1)
            else:
                sys.exit(1)
    elif args.mode == "prune":
        from tpuclip_torch.pipelines.prune import prune_missing

        db_path = _require_existing_db_path(args, paths)
        prune_missing(db_path, folders=args.folder, dry_run=args.dry_run)
    elif args.mode == "migrate":
        import sqlite3

        from tpuclip_torch.index.migrate import migrate_reference_db

        db_path = _require_existing_db_path(args, paths)
        try:
            migrate_reference_db(db_path, dry_run=args.dry_run)
        except (ValueError, sqlite3.DatabaseError) as e:
            # DatabaseError: --db pointed at a non-sqlite file.
            log(f"[X] Error: {e}")
            sys.exit(2)
    elif args.mode == "export":
        from tpuclip_torch.pipelines.export import export_embeddings

        db_path = _require_existing_db_path(args, paths)
        fmt = args.format
        if fmt is None:
            ext = os.path.splitext(args.output)[1].lower().lstrip(".")
            fmt = ext if ext in ("npz", "npy", "jsonl") else "npz"
        try:
            export_embeddings(db_path, args.output, fmt=fmt, include_binary=args.binary)
        except ValueError as e:
            log(f"[X] Error: {e}")
            sys.exit(2)
    elif args.mode == "duplicates":
        from tpuclip_torch.pipelines.duplicates import report_duplicates

        db_path = _require_existing_db_path(args, paths)
        report_duplicates(db_path, tolerance_bits=args.tolerance)
    elif args.mode == "train":
        from tpuclip_torch.parallel.checkpoint import TrainStateError
        from tpuclip_torch.pipelines.train import train

        try:
            train(
                args.data,
                model_name=_model_name(args),
                model_cache_dir=args.model_cache or None,
                output_dir=args.output,
                steps=args.steps,
                batch_size=args.batch_size,
                learning_rate=args.lr,
                resume=args.resume,
                seed=args.seed,
                optimizer=args.optimizer,
                device=args.device,
            )
        except TrainStateError as e:  # a --resume the port cannot read
            log(f"[X] Error: {e}")
            sys.exit(2)
    else:
        parser.print_help()


def _run_info(args, paths) -> None:
    """DB summary without loading the model (fast operator tool)."""
    import sqlite3

    from tpuclip_torch.index.store import MetadataStore

    db_path = _require_existing_db_path(args, paths)
    store = MetadataStore(db_path)
    dim = store.stored_embedding_dim()
    full, binary = store.count_embeddings()
    images = store.count_images()
    size_mb = os.path.getsize(db_path) / 1e6
    log(f"Database: {db_path} ({size_mb:.1f} MB)")
    log(f"  Images:            {images:,}")
    log(f"  Full embeddings:   {full:,}")
    log(f"  Binary embeddings: {binary:,}")
    log(f"  Embedding dim:     {dim or 'unknown'}")
    conn = sqlite3.connect(db_path)
    try:
        if dim and full:
            names = {dim * 4: "fp32", dim * 2: "fp16", dim + 4: "int8"}
            parts = [
                f"{names.get(ln, f'{ln}B?')} x {n:,}"
                for ln, n in conn.execute(
                    "SELECT LENGTH(vector), COUNT(*) FROM embeddings "
                    "GROUP BY LENGTH(vector) ORDER BY COUNT(*) DESC"
                )
            ]
            log(f"  Vector storage:    {' + '.join(parts)}")
        newest = conn.execute("SELECT MAX(created_at) FROM images").fetchone()[0]
        log(f"  Last insert:       {newest or '-'}")
    finally:
        conn.close()
    cache_dir = Path(str(db_path) + ".cache")
    if cache_dir.exists():
        cache_mb = sum(f.stat().st_size for f in cache_dir.iterdir()) / 1e6
        log(f"  Matrix cache:      {cache_mb:.1f} MB ({cache_dir})")
    else:
        log("  Matrix cache:      not built (first search will build it)")
    thumbs = Path(paths.thumbnails_dir)
    if thumbs.is_dir():
        files = [f for f in thumbs.iterdir() if f.suffix == ".jpg"]
        thumb_mb = sum(f.stat().st_size for f in files) / 1e6
        log(f"  Thumbnails:        {len(files):,} files, {thumb_mb:.1f} MB (reclaim orphans with `tpuclip gc`)")


_NO_DATABASES = "No databases found; refusing to GC (every thumbnail would look orphaned)."


def _run_gc(args, paths) -> None:
    """Reclaim thumbnails whose content hash no database references, and
    bound the decode cache. Keeps the hashes of every .db in the databases
    dir unless ``--db`` names some. Where no named database exists, the
    thumbnail GC is refused (exit 2) after the decode cache named by
    ``--decode-cache`` is bounded; tpuclip exits before that bound."""
    from tpuclip_torch.io.thumbnails import Thumbnailer, referenced_hashes_for_dbs

    dbs = (
        list(args.db)
        if args.db
        else [os.path.join(paths.db_dir, name) for name in list_db_files(paths.db_dir)]
    )
    dbs = [d for d in dbs if os.path.exists(d)]
    verb = "Would remove" if args.dry_run else "Removed"
    cache_only = args.decode_cache is not None and not args.db
    refuse = not dbs and not cache_only
    if refuse and args.decode_cache is None:
        log(_NO_DATABASES)
        sys.exit(2)
    if dbs:
        log(f"Scanning {len(dbs)} database(s) for referenced hashes...")
        referenced = referenced_hashes_for_dbs(dbs)
        log(f"  {len(referenced):,} referenced content hashes")
        thumbnailer = Thumbnailer(paths.thumbnails_dir)
        removed, reclaimed = thumbnailer.gc_orphans(referenced, dry_run=args.dry_run)
        log(f"{verb} {removed:,} orphaned thumbnail(s), reclaiming {reclaimed / 1e6:.1f} MB")

    # The decode cache (TPUCLIP_DECODE_CACHE) grows without bound otherwise.
    cache_dir = args.decode_cache or os.environ.get("TPUCLIP_DECODE_CACHE")
    if cache_dir and os.path.isdir(cache_dir):
        from tpuclip_torch.io.prefetch import gc_decode_cache

        max_bytes = (
            int(args.decode_cache_max_gb * 1e9)
            if args.decode_cache_max_gb is not None
            else None
        )
        n, freed, kept = gc_decode_cache(cache_dir, max_bytes, dry_run=args.dry_run)
        if max_bytes is None:
            log(f"Decode cache: {kept / 1e9:.2f} GB at {cache_dir} "
                "(bound it with --decode-cache-max-gb)")
        else:
            log(f"{verb} {n:,} decode-cache entr(ies), reclaiming "
                f"{freed / 1e9:.2f} GB; {kept / 1e9:.2f} GB kept")
    elif args.decode_cache is not None:
        # An explicitly named dir that does not exist is an error, not a
        # silent no-op.
        log(f"[X] Error: --decode-cache {args.decode_cache} is not a directory")
        sys.exit(2)
    elif args.decode_cache_max_gb is not None:
        log("[WARNING] --decode-cache-max-gb given but no decode cache dir "
            "(pass --decode-cache DIR or set TPUCLIP_DECODE_CACHE); skipped.")
    if refuse:
        log(_NO_DATABASES)
        sys.exit(2)


def _run_convert(args) -> None:
    """HF-layout (or tpuclip-native) checkpoint → tpuclip-native; no model
    is built, the parameters stay numpy on the host."""
    from tpuclip_torch.models.checkpoint import save_checkpoint
    from tpuclip_torch.models.loader import find_local_checkpoint, load_checkpoint_dir

    src = args.src
    if not Path(src).is_dir():
        located = find_local_checkpoint(src, args.model_cache)
        if located is None:
            log(f"[X] Error: {src} is neither a directory nor a cached model name")
            sys.exit(2)
        src = str(located)
    log(f"Converting {src} ...")
    cfg, params = load_checkpoint_dir(src, model_name=args.src if "/" in args.src else None)
    save_checkpoint(args.dst, params, cfg)
    log(f"[OK] Wrote tpuclip checkpoint: {args.dst} ({cfg.name})")


if __name__ == "__main__":
    main()
