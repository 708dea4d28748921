"""Host-side image decode.

Equivalent of ``_load_image`` (image_database.py:408-441): PIL open + RGB
convert for raster formats; first PDF page rendered at 150 DPI via PyMuPDF
when available (gated import, same as the reference's PDF_SUPPORT flag,
image_database.py:132-137). Decode stays on host CPU — TPUs have no image
codecs — but everything downstream (resize output batching, normalization)
is pipelined; see tpuclip.io.prefetch.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from PIL import Image

from tpuclip_torch.utils.logging import safe_print_path

try:  # PDF support — optional, mirrors image_database.py:132-137
    import fitz  # type: ignore  # PyMuPDF

    PDF_SUPPORT = True
except ImportError:
    fitz = None
    PDF_SUPPORT = False

# Raise PIL's ~89MP default so large scans/panoramas decode
# (image_database.py:142).
Image.MAX_IMAGE_PIXELS = 500_000_000

IMAGE_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp", ".tiff", ".tif"}


def supported_extensions(include_pdf: Optional[bool] = None) -> set:
    exts = set(IMAGE_EXTENSIONS)
    if include_pdf if include_pdf is not None else PDF_SUPPORT:
        exts.add(".pdf")
    return exts


def load_image(
    image_path: str, draft_size: Optional[int] = None
) -> Optional[Image.Image]:
    """Load an RGB PIL image, or None on any failure (containment:
    a bad file must never kill a scan, image_database.py:439-441).

    ``draft_size``: opt-in JPEG fast path — libjpeg DCT-domain scaling
    decodes directly at >= (draft_size, draft_size) instead of full
    resolution, typically 3-8x faster for multi-megapixel photos. Pixel
    values differ slightly from a full decode (different downsampling
    chain), so it is NOT used by default; enable with
    ``TPUCLIP_FAST_DECODE=1`` / ``scan --fast-decode`` when byte-level
    preprocessing parity with the reference does not matter.
    """
    try:
        file_ext = Path(image_path).suffix.lower()
        if file_ext == ".pdf":
            if not PDF_SUPPORT:
                safe_print_path("PDF support not available for ", image_path, None)
                return None
            try:
                doc = fitz.open(image_path)
                try:
                    if len(doc) == 0:
                        return None
                    page = doc[0]
                    mat = fitz.Matrix(150 / 72, 150 / 72)  # 150 DPI render
                    pix = page.get_pixmap(matrix=mat)
                    return Image.frombytes("RGB", (pix.width, pix.height), pix.samples)
                finally:
                    doc.close()
            except Exception as pdf_error:  # noqa: BLE001
                safe_print_path("Error converting PDF ", image_path, pdf_error)
                return None
        return _decode_raster(image_path, draft_size)
    except Exception as e:  # noqa: BLE001
        safe_print_path("Error loading ", image_path, e)
        return None


def _decode_raster(fp, draft_size: Optional[int]) -> Image.Image:
    """Shared raster decode for path and in-memory sources."""
    img = Image.open(fp)
    if draft_size is not None and img.format == "JPEG":
        # libjpeg picks the most aggressive DCT scale whose output still
        # covers (draft_size, draft_size) in BOTH dims, so the final square
        # resize never upsamples. (Requesting 2x here — an earlier
        # conservative choice — silently disabled scaling for common
        # 1024x768 photos: 768/2 < 448, so no scale qualified.)
        img.draft("RGB", (draft_size, draft_size))
    if img.mode != "RGB":
        return img.convert("RGB")
    # Already RGB (the common JPEG case): convert() would copy the full
    # frame for nothing (~0.7 ms/megapixel-decoded). Decode NOW regardless —
    # truncated/corrupt files must raise here, inside the callers'
    # containment (-> None), not later in a consumer's resize.
    img.load()
    return img


def load_image_bytes(
    data: bytes, image_path: str, draft_size: Optional[int] = None
) -> Optional[Image.Image]:
    """``load_image`` for already-read raster bytes (same containment and
    draft semantics; PDFs must go through ``load_image``).

    Lets the scan pipeline read each file exactly once — the same bytes feed
    SHA-256 and the decoder — instead of the reference's separate hash read
    (image_database.py:346-352 after :408).
    """
    import io

    try:
        return _decode_raster(io.BytesIO(data), draft_size)
    except Exception as e:  # noqa: BLE001
        safe_print_path("Error loading ", image_path, e)
        return None
