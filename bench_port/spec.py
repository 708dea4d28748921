"""Find a cell's pieces by name.

``BENCHMARK.json`` names the cell, its configuration (whose ``file`` holds
the sizes) and its traffic mix. The mix is ``traffic/<traffic>.json``, the
limits of the check are ``limits/<workload>.json``, the driver is
``drivers/<driver>.py`` (the mix's ``driver`` key) and each per-layer metric
is read by ``metrics/<metric>.py``, which defines ``read(ctx)``.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

PKG = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Layout:
    """Where the pieces live. ``root`` holds ``BENCHMARK.json``; a
    configuration's ``file`` is relative to it."""

    root: Path = PKG.parent
    traffic_dir: Path = PKG / "traffic"
    limits_dir: Path = PKG / "limits"
    metrics_dir: Path = PKG / "metrics"
    drivers_dir: Path = PKG / "drivers"


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    driver: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable] = field(default_factory=dict)


def _read_json(path: Path) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def _load_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path} for {name!r}")
    spec = importlib.util.spec_from_file_location(f"bench_port._found.{name}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # dataclasses look their module up there
    spec.loader.exec_module(module)
    return module


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, layout: Layout = Layout()) -> Cell:
    """Every piece of ``workload``, found by name; raises if one is missing."""
    bench = _read_json(layout.root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _read_json(layout.root / entry["file"])
    if config.get("name") != entry["name"]:
        raise ValueError(f"{entry['file']} names {config.get('name')!r}, not {entry['name']!r}")
    traffic = _read_json(layout.traffic_dir / f"{w['traffic']}.json")
    limits = _read_json(layout.limits_dir / f"{workload}.json")
    driver = _load_module(layout.drivers_dir / f"{traffic['driver']}.py", f"driver_{traffic['driver']}")
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    readers = {
        m["name"]: _load_module(layout.metrics_dir / f"{m['name']}.py", m["name"].replace(".", "_")).read
        for m in per_layer
    }
    return Cell(
        workload=w, config=config, traffic=traffic, limits=limits, driver=driver,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=per_layer, readers=readers,
    )
