"""Content hashing.

Same contract as ``_get_file_hash`` (image_database.py:346-352): streaming
SHA-256 hex digest. We read in 1 MiB chunks instead of the reference's 4 KiB —
the digest is identical, the syscall count is ~256x lower. An authored C++
SHA-256 (tpuclip.native) is available as an alternative backend; OpenSSL via
hashlib is used by default since it is already vectorized.
"""

from __future__ import annotations

import hashlib

_CHUNK = 1 << 20


def file_sha256(file_path: str) -> str:
    sha256 = hashlib.sha256()
    with open(file_path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            sha256.update(chunk)
    return sha256.hexdigest()
