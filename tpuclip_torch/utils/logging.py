"""Status logging helpers.

The reference communicates progress via ``print(..., flush=True)`` status lines
(image_database.py:139,149) and has a Unicode-safe path printer
(image_database.py:393-406). We keep that surface but route through one place
so it can be silenced or redirected (e.g. under pytest or when embedding the
library).
"""

from __future__ import annotations

import os
import sys
from typing import Optional


def _enabled() -> bool:
    return os.environ.get("TPUCLIP_QUIET", "") not in ("1", "true", "yes")


def log(*args, **kwargs) -> None:
    """print(..., flush=True) unless TPUCLIP_QUIET is set."""
    if _enabled():
        kwargs.setdefault("flush", True)
        print(*args, **kwargs)


def safe_print_path(message: str, file_path: str, error: Optional[Exception] = None) -> None:
    """Print a message containing a path that may not be encodable on the
    current stdout codec; fall back to ASCII-replaced form
    (image_database.py:393-406)."""
    suffix = f": {error}" if error else ""
    try:
        log(f"{message}{file_path}{suffix}")
    except UnicodeEncodeError:
        # Sanitize the WHOLE line: the error text usually embeds the same
        # non-encodable path (e.g. FileNotFoundError), so replacing only
        # file_path would re-raise from the fallback itself.
        safe = f"{message}{file_path}{suffix}".encode("ascii", "replace").decode("ascii")
        log(safe)


def banner(title: str, width: int = 60) -> None:
    log("=" * width)
    log(title)
    log("=" * width)


def is_tty() -> bool:
    try:
        return sys.stdin.isatty()
    except Exception:  # noqa: BLE001
        return False
