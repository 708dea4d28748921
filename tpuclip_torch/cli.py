"""Command-line interface of the PyTorch port: ``scan``, ``search`` and
``serve``.

Same flags as ``tpuclip scan`` / ``search`` / ``serve`` (tpuclip/cli.py),
plus ``--device {cuda,cpu}`` (default ``cuda``; the CPU only when named).
The REPL's line grammar (``parse_interactive_line``) is here, for serve's
query mini-language; the interactive session and the other subcommands are
not ported yet (ROADMAP Queue 1 item 3). Usage::

    python -m tpuclip_torch.cli scan DIR --db photos.db
    python -m tpuclip_torch.cli search "a red car" -k 20 --db photos.db --no-session
    python -m tpuclip_torch.cli serve --db photos.db --port 8000 --warm
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

from tpuclip_torch.config import default_paths, list_db_files, resolve_db_path
from tpuclip_torch.utils.logging import log


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
    search_parser.add_argument("--interactive", "-i", action="store_true", help="Interactive session mode (not ported yet: pass --no-session)")
    search_parser.add_argument("--no-session", action="store_true", help="Exit after processing query instead of keeping session open")
    search_parser.add_argument("--folder", action="append", help="Filter results to images in this folder (repeatable)")
    search_parser.add_argument("--profile", action="store_true", help="Show performance profiling information for search")
    search_parser.add_argument("--show-duplicates", action="store_true", help="Show duplicate images in results (default: filtered)")
    search_parser.add_argument("--model", default=None, help="Model preset name (default: google/siglip2-so400m-patch14-224)")
    search_parser.add_argument("--precision", choices=["bf16", "int8"], default=None, help="Search precision: int8 quantized scan with exact re-rank (the default) or the plain bf16 scan")
    search_parser.add_argument("--mode", dest="search_mode", choices=["exact", "ivf", "cascade"], default=None, help="Search mode: exact scan (default), or cascade (packed-binary prefilter + exact fp32 rescore from the host; no flat matrix on the device); ivf is not ported yet")

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

    for sub in (scan_parser, search_parser, serve_parser):
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


def _make_engine(db_path: str, args):
    from tpuclip_torch.engine import ImageDatabase
    from tpuclip_torch.models.configs import DEFAULT_MODEL

    if getattr(args, "precision", None):
        os.environ["TPUCLIP_SEARCH_PRECISION"] = args.precision
    # dest is search_mode: "mode" already carries the subcommand name
    if getattr(args, "search_mode", None):
        os.environ["TPUCLIP_SEARCH_MODE"] = args.search_mode
    return ImageDatabase(
        db_path,
        args.model_cache or None,
        model_name=args.model or os.environ.get("TPUCLIP_MODEL", DEFAULT_MODEL),
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

    if args.interactive or (args.query is not None and not args.no_session):
        log(
            "Error: the interactive session is not ported to tpuclip_torch yet "
            "(ROADMAP Queue 1 item 3); pass --no-session for a single query."
        )
        sys.exit(2)

    log("Initializing database connection and loading model...")
    db = _make_engine(db_path, args)

    # Single-shot mode (image_database.py:2300-2362)
    if not args.query:
        log("Error: Query required")
        return

    if args.query2:
        log("Combined search:")
        log(f"  Query 1: {args.query} ({'image' if args.image else 'text'})")
        log(f"  Query 2: {args.query2} ({'image' if args.image2 else 'text'})")
        log(f"  Weights: {args.weights[0]:.1f} / {args.weights[1]:.1f}")
    if args.negative:
        log(f"  Negative: {args.negative} ({'image' if args.negative_image else 'text'})")

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

    display_query = args.query
    if args.query2:
        display_query += f" + {args.query2}"
    if args.negative:
        display_query += f" - {args.negative}"
    db.generate_html_gallery(results, output_file, query=display_query)
    log(f"\nResults saved to {output_file}")


def main(argv: Optional[List[str]] = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    paths = default_paths()
    if args.mode == "scan":
        _run_scan(args, paths)
    elif args.mode == "search":
        _run_search(args, paths)
    elif args.mode == "serve":
        from tpuclip_torch.serve import run_serve

        run_serve(args, paths)
    else:
        parser.print_help()


if __name__ == "__main__":
    main()
