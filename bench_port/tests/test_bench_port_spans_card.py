"""On a card, each cell of ``BENCHMARK.json`` at its own size, traced for a
few seconds: at least 99% of the window's compute-kernel time has a
program span for its owner (``bench_port/spans.py``), no program span
name is among the device operations, a device-idle gap inside a call is
named by the engine's step, and the three tower metrics are parts of
``tower.device_ms_per_image``. Prints one ``[spans-json]`` line a cell:
the kernel time of each owner per image. Marked ``cuda``; skips without a
card.

    python3 -m pytest bench_port/tests -q -m cuda -s
"""

import json
import time
from types import SimpleNamespace

import pytest

from conftest import ROOT

from bench_port import run, spans, trace
from bench_port.spec import load_cell

WORKLOADS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
TOWER = ["tower.attn_core_ms_per_image", "tower.attn_proj_ms_per_image", "tower.mlp_ms_per_image"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_kernels_have_program_owners_on_the_card(workload, card, tmp_path):
    cell = load_cell(workload)
    with run.program_home(tmp_path) as workdir:
        state = cell.driver.setup(cell, 2**31 + 505, card, workdir, run.SetupTimer(time.perf_counter()))
        _, window, prof = run._measure(cell, state, 3.0, True)
        cell.driver.release(state)
    timeline = trace.from_profiler(prof)
    program = spans.from_events(prof.profiler.kineto_results.events())
    a, b = timeline.window
    total = timeline.busy_ns(a, b, trace.union([(s, e) for s, e, _ in timeline.kernels]))
    by_owner = program.kernel_ns_by_owner(timeline.window)
    owned = sum(ns for owner, ns in by_owner.items() if owner is not None)
    print("[spans-json] " + json.dumps({
        "workload": workload, "images": window.items, "calls": window.calls, "owned_share": owned / total,
        "ms_per_image": {str(owner): ns / window.items / 1e6 for owner, ns in sorted(by_owner.items(), key=str)},
        "idle_gaps": trace.idle_gaps(timeline)}))
    assert owned >= 0.99 * total > 0
    assert not any(name.startswith(spans.PROGRAM_PREFIXES) for name, _ in trace.device_ops(timeline, top=10**6))
    assert any(label.startswith("call/engine.") for label, _ in trace.idle_gaps(timeline))
    ctx = SimpleNamespace(timeline=timeline, images=window.items, program=program)
    got = {name: cell.readers[name](ctx) for name in TOWER + ["tower.device_ms_per_image"]}
    assert all(got[name] > 0 for name in TOWER)
    assert sum(got[name] for name in TOWER) <= got["tower.device_ms_per_image"]
