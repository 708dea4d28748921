"""Configuration loading and path resolution.

Behavior contract follows the reference (image_database.py:27-121):

- ``config.json`` is discovered next to the repo root, then one directory up,
  so a private config can live outside the publishable folder.
- Keys: ``database_dir``, ``model_cache_dir``, ``results_dir``,
  ``thumbnails_dir`` (legacy ``database_path`` honored for back-compat).
- Relative paths resolve against the *parent* of the repo directory
  (the "output base"); absolute paths are used as-is.
- DB selection is deliberately explicit: ``--db <path>`` or
  ``--db-name <name[.db]>`` resolved under ``database_dir``
  (image_database.py:95-109).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

# The "script dir" for config discovery purposes is the repository root
# (parent of this package), mirroring the reference's single-file layout
# where config.json sits next to image_database.py (image_database.py:35-39).
_REPO_ROOT = Path(__file__).resolve().parent.parent

DEFAULT_CONFIG: Dict[str, str] = {
    "database_dir": "",
    "model_cache_dir": "models",
    "results_dir": "results",
    "thumbnails_dir": "thumbnails",
}


def load_config(base_dir: Optional[Path] = None) -> Dict[str, str]:
    """Load configuration from config.json.

    Lookup order (image_database.py:27-58):
      1) ``<base_dir>/config.json``
      2) ``<base_dir>/../config.json``
    Falls back to :data:`DEFAULT_CONFIG` on absence or parse error.
    """
    base = Path(base_dir) if base_dir is not None else _REPO_ROOT
    candidates = [base / "config.json", base.parent / "config.json"]
    for config_path in candidates:
        if not config_path.exists():
            continue
        try:
            with open(config_path, "r", encoding="utf-8") as f:
                return json.load(f)
        except Exception as e:  # noqa: BLE001 - mirror reference's forgiving load
            print(f"Warning: Could not load config.json at {config_path}: {e}")
            print("Using default configuration.")
    return dict(DEFAULT_CONFIG)


def resolve_path(config_path: str, base_dir: Path) -> str:
    """Resolve a config path: absolute used as-is, else joined with base_dir."""
    if not config_path:
        return ""
    path = Path(config_path)
    if path.is_absolute():
        return str(path)
    return str(base_dir / path)


def resolve_db_dir(config_dir: str, base_dir: Path, config: Optional[Dict[str, str]] = None) -> str:
    """Resolve the database directory; falls back to legacy ``database_path``'s
    parent, then to ``base_dir`` (image_database.py:71-83)."""
    if config_dir:
        return resolve_path(config_dir, base_dir)
    cfg = config if config is not None else {}
    db_path = cfg.get("database_path", "")
    if db_path:
        resolved = resolve_path(db_path, base_dir)
        try:
            return str(Path(resolved).parent)
        except Exception:  # noqa: BLE001
            pass
    return str(base_dir)


def list_db_files(db_dir: str) -> List[str]:
    """List ``.db`` files in db_dir, non-recursive (image_database.py:85-93)."""
    try:
        p = Path(db_dir)
        if not p.exists() or not p.is_dir():
            return []
        return sorted(f.name for f in p.iterdir() if f.is_file() and f.suffix.lower() == ".db")
    except Exception:  # noqa: BLE001
        return []


def resolve_db_path(args_db: Optional[str], args_db_name: Optional[str], db_dir: str) -> str:
    """Resolve a DB path from ``--db`` / ``--db-name`` (image_database.py:95-109).

    Raises ValueError when neither is given — DB selection is mandatory.
    """
    if args_db:
        return str(Path(args_db))
    if args_db_name:
        name = args_db_name
        if not name.lower().endswith(".db"):
            name += ".db"
        return str(Path(db_dir) / name)
    raise ValueError("No database specified")


@dataclass(frozen=True)
class Paths:
    """Resolved default paths for the current configuration."""

    db_dir: str
    db_path: str
    model_cache_dir: str
    results_dir: str
    thumbnails_dir: str
    output_base: str


def get_paths(base_dir: Optional[Path] = None, config: Optional[Dict[str, str]] = None) -> Paths:
    """Compute the default path set (image_database.py:111-121).

    Outputs resolve against the parent of the repo directory, matching the
    reference's ``_OUTPUT_BASE`` convention.
    """
    base = Path(base_dir) if base_dir is not None else _REPO_ROOT
    cfg = config if config is not None else load_config(base)
    output_base = base.parent
    db_dir = resolve_db_dir(cfg.get("database_dir", ""), output_base, cfg)
    return Paths(
        db_dir=db_dir,
        db_path=str(Path(db_dir) / "image_database.db"),
        model_cache_dir=resolve_path(cfg.get("model_cache_dir", "models"), output_base),
        results_dir=resolve_path(cfg.get("results_dir", "results"), output_base),
        thumbnails_dir=resolve_path(cfg.get("thumbnails_dir", "thumbnails"), output_base),
        output_base=str(output_base),
    )


# Environment override: tests and sandboxed runs point everything at a tmp dir
# via TPUCLIP_HOME instead of writing beside the repo.
def default_paths() -> Paths:
    home = os.environ.get("TPUCLIP_HOME")
    if home:
        base = Path(home)
        return Paths(
            db_dir=str(base / "databases"),
            db_path=str(base / "databases" / "image_database.db"),
            model_cache_dir=str(base / "models"),
            results_dir=str(base / "results"),
            thumbnails_dir=str(base / "thumbnails"),
            output_base=str(base),
        )
    return get_paths()
