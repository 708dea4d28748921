"""Directory census, exclusion pruning, and frame-sequence sampling.

Same behavior as the reference scan front-end:
- ``os.walk`` census with case-insensitive extension filtering, ``._*``
  resource-fork skipping, absolute-path dedup, 50k-file progress ticks, and
  exclude-dir pruning via ``dirs[:] = []`` (image_database.py:751-847).
- Files grouped by parent directory, folders processed in sorted order
  (folder-level resume, image_database.py:834-843, :882).
- Sequence sampling heuristic (image_database.py:606-690): big folders whose
  name or dominant numeric-suffix prefix looks like a frame/render sequence
  keep only every 100th frame; camera-style prefixes (IMG_/DSC_/...) are
  never sampled; non-numbered files are always kept.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from tpuclip_torch.utils.logging import log

FOLDER_SEQUENCE_KEYWORDS = (
    "frame", "frames", "render", "renders", "sequence", "seq", "anim",
    "animation", "motion", "video",
)
PREFIX_SEQUENCE_KEYWORDS = (
    "frame", "render", "shot", "output", "seq", "sequence", "anim", "animation",
)
PHOTO_PREFIXES = {
    "img", "dsc", "pict", "photo", "pxl", "mvimg", "dji", "gopr", "gopro", "scan",
}
SAMPLE_THRESHOLD = 150
SAMPLE_STRIDE = 100
DOMINANT_FRACTION = 0.8


def sample_folder_sequences(files: List[Path]) -> List[Path]:
    """Sample likely frame sequences to avoid indexing thousands of
    near-identical frames (reference heuristic, image_database.py:606-690)."""
    if len(files) <= SAMPLE_THRESHOLD or not files:
        return files

    folder_name = files[0].parent.name.lower()
    folder_looks_like_sequence = any(k in folder_name for k in FOLDER_SEQUENCE_KEYWORDS)

    numbered_files: List[Tuple[int, Path, str]] = []
    for f in files:
        match = re.search(r"^(.*?)(\d+)$", f.stem)
        if match:
            prefix = (match.group(1) or "").lower()
            numbered_files.append((int(match.group(2)), f, prefix))

    if len(numbered_files) <= SAMPLE_THRESHOLD:
        return files

    prefix_counts: Dict[str, int] = {}
    for _, _, pfx in numbered_files:
        prefix_counts[pfx] = prefix_counts.get(pfx, 0) + 1
    dominant_prefix, dominant_count = max(prefix_counts.items(), key=lambda kv: kv[1])
    dominant_frac = dominant_count / max(1, len(numbered_files))

    pfx_stripped = dominant_prefix.strip().strip("_- ")
    dominant_is_photoish = pfx_stripped in PHOTO_PREFIXES or dominant_prefix.startswith(
        ("img_", "dsc_", "pxl_", "mvimg_", "dji_", "gopr_")
    )
    prefix_looks_like_sequence = any(k in dominant_prefix for k in PREFIX_SEQUENCE_KEYWORDS)

    should_sample = (
        dominant_frac >= DOMINANT_FRACTION
        and (folder_looks_like_sequence or prefix_looks_like_sequence)
        and not dominant_is_photoish
    )
    if not should_sample:
        return files

    numbered_files.sort(key=lambda x: x[0])
    frames_to_keep = {numbered_files[i][1] for i in range(0, len(numbered_files), SAMPLE_STRIDE)}
    numbered_set = {f for _, f, _ in numbered_files}
    result = []
    for f in files:
        if f in numbered_set:
            if f in frames_to_keep:
                result.append(f)
        else:
            result.append(f)  # non-numbered files always kept
    return result


def census(
    root_dir: str,
    exclude_paths: Optional[Sequence[str]] = None,
    extensions: Optional[set] = None,
    report_interval: int = 50000,
    verbose: bool = True,
) -> Tuple[List[Path], int]:
    """Walk ``root_dir`` and return (image files, excluded dir count).

    Matches the reference census (image_database.py:751-829): case-insensitive
    extensions, skip ``._*``, absolute-path set dedup, exclusion by
    case-insensitive prefix with subtree pruning.
    """
    if extensions is None:
        from tpuclip_torch.io.decode import supported_extensions

        extensions = supported_extensions()
    extensions = {e.lower() for e in extensions}

    exclude_abs = [os.path.abspath(p) for p in (exclude_paths or [])]

    image_files_set = set()
    excluded_count = 0
    last_report = 0
    root_str = str(Path(root_dir).absolute())
    for root, dirs, files in os.walk(root_str):
        root_norm = os.path.abspath(root).lower()
        should_skip = False
        for excl in exclude_abs:
            excl_norm = excl.lower()
            if root_norm == excl_norm or root_norm.startswith(excl_norm + os.sep):
                dirs[:] = []  # prune subtree
                should_skip = True
                excluded_count += 1
                break
        if should_skip:
            continue
        for file in files:
            if file.startswith("._"):  # macOS resource forks
                continue
            if os.path.splitext(file)[1].lower() in extensions:
                image_files_set.add(os.path.abspath(os.path.join(root, file)))
                if len(image_files_set) - last_report >= report_interval:
                    if verbose:
                        log(f"  Found {len(image_files_set):,} unique image files so far...")
                    last_report = len(image_files_set)

    return [Path(p) for p in image_files_set], excluded_count


def group_by_folder(image_files: List[Path]) -> List[Tuple[Path, List[Path]]]:
    """Group by parent dir, sorted by folder path for deterministic,
    resumable processing order (image_database.py:834-843, :882)."""
    files_by_dir: Dict[Path, List[Path]] = {}
    for img_file in image_files:
        files_by_dir.setdefault(img_file.parent, []).append(img_file)
    return sorted(files_by_dir.items(), key=lambda x: str(x[0]))
