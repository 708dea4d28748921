"""Thumbnails for non-browser-renderable formats (PDF/TIF/BMP).

Contract from the reference (image_database.py:354-391): content-hash-named
JPEGs (``<thumbnails_dir>/<sha256>.jpg``), 400x400 LANCZOS, quality 85,
created during scan commits and on-demand at gallery time.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Tuple

from PIL import Image

from tpuclip_torch.io.decode import load_image
from tpuclip_torch.io.hashing import file_sha256
from tpuclip_torch.utils.logging import safe_print_path

THUMBNAIL_FORMATS = {".pdf", ".tif", ".tiff", ".bmp"}


def needs_thumbnail(file_path: str) -> bool:
    return Path(file_path).suffix.lower() in THUMBNAIL_FORMATS


class Thumbnailer:
    def __init__(self, thumbnails_dir: str):
        self.thumbnails_dir = Path(thumbnails_dir)

    def thumbnail_path(self, file_path: str, file_hash: Optional[str] = None) -> str:
        if file_hash is None:
            file_hash = file_sha256(file_path)
        self.thumbnails_dir.mkdir(parents=True, exist_ok=True)
        return str(self.thumbnails_dir / f"{file_hash}.jpg")

    def create(
        self,
        file_path: str,
        max_size: Tuple[int, int] = (400, 400),
        file_hash: Optional[str] = None,
    ) -> Optional[str]:
        """Create (or return existing) thumbnail; None on failure."""
        try:
            thumbnail_path = self.thumbnail_path(file_path, file_hash)
            if os.path.exists(thumbnail_path):
                return thumbnail_path
            image = load_image(file_path)
            if image is None:
                return None
            image.thumbnail(max_size, Image.Resampling.LANCZOS)
            if image.mode != "RGB":
                image = image.convert("RGB")
            # Write-then-rename: a crash/disk-full mid-save must not leave a
            # truncated .jpg behind — the exists() check above would serve it
            # as a valid cached thumbnail forever after.
            tmp_path = f"{thumbnail_path}.{os.getpid()}.tmp"
            try:
                image.save(tmp_path, "JPEG", quality=85)
                os.replace(tmp_path, thumbnail_path)
            except BaseException:
                try:
                    os.unlink(tmp_path)
                except OSError:
                    pass
                raise
            return thumbnail_path
        except Exception as e:  # noqa: BLE001
            safe_print_path("Error creating thumbnail for ", file_path, e)
            return None

    def ensure_for(self, file_path: str, file_hash: Optional[str] = None) -> None:
        """Commit-time hook: thumbnail PDF/TIF/BMP only (image_database.py:1132).

        ``file_hash``: pass the scan's already-computed SHA-256 to avoid
        re-reading and re-hashing the whole file just to name the thumbnail.
        """
        if needs_thumbnail(file_path):
            self.create(file_path, file_hash=file_hash)

    def gc_orphans(self, referenced_hashes, dry_run: bool = False) -> Tuple[int, int]:
        """Delete sha-named thumbnails whose hash no database references.

        Returns (files_removed, bytes_reclaimed). The reference accumulates
        thumbnails forever; pass the union of file_hash values across every
        database that shares this thumbnails directory.
        """
        if not self.thumbnails_dir.is_dir():
            return 0, 0
        referenced = set(referenced_hashes)
        removed = 0
        reclaimed = 0
        for f in self.thumbnails_dir.iterdir():
            if f.suffix != ".jpg" or f.stem in referenced:
                continue
            size = f.stat().st_size
            if not dry_run:
                try:
                    f.unlink()
                except OSError as e:
                    safe_print_path("Error removing thumbnail ", str(f), e)
                    continue
            removed += 1
            reclaimed += size
        return removed, reclaimed


def referenced_hashes_for_dbs(db_paths) -> set:
    """Union of images.file_hash across databases (for gc_orphans)."""
    import sqlite3

    hashes: set = set()
    for db in db_paths:
        # Read-only open: a plain connect() on a mistyped path would CREATE an
        # empty db file before failing on the query.
        conn = sqlite3.connect(f"file:{db}?mode=ro", uri=True)
        try:
            rows = conn.execute(
                "SELECT file_hash FROM images WHERE file_hash IS NOT NULL"
            ).fetchall()
            hashes.update(r[0] for r in rows)
        finally:
            conn.close()
    return hashes
