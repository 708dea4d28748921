"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m bench_port.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the CUDA context, the engine, the seeded weights and
inputs, the warm-up of the cell's one batch shape) is ``setup_s``; then the
cell's driver calls the program back to back for ``--seconds``. With
``--trace 1`` the same window runs under ``torch.profiler`` and the line
carries the per-layer metrics instead of the end-to-end ones. After the
window the program is freed and the plain reference decides ``correct``.
The last line of standard output is the result; the numbers compared, each
beside its limit, are the last lines of standard error and the result's
last key.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here, before any import

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Optional  # noqa: E402

from bench_port.spec import PKG, Layout, load_cell  # noqa: E402

# Whole top-level module names that no run may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuclip")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


class SetupTimer:
    """Splits set-up into named laps."""

    def __init__(self, t0: float):
        self.last = t0
        self.parts = []

    def lap(self, label: str) -> None:
        now = time.perf_counter()
        self.parts.append((label, now - self.last))
        self.last = now


@dataclass
class Window:
    calls: int
    items: int
    seconds: float


@dataclass
class TraceContext:
    """What a per-layer metric reader reads."""

    timeline: object  # bench_port.trace.Timeline
    images: int
    flops: float
    peak_flops: Optional[float]


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


@contextlib.contextmanager
def _env(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def program_home(root: Path):
    """The program's environment for one run: kernel caches at fixed paths
    inside the checkout (``build/bench_port/``), and a temporary
    ``TPUCLIP_HOME`` under ``TMPDIR`` for the engine's database, removed
    afterwards; random weights (the benchmark copies its own over them);
    ``transformers``, if anything loads it, without JAX."""
    caches = root / "build" / "bench_port"
    workdir = tempfile.mkdtemp(prefix="bench_port_")
    try:
        with _env(TORCH_EXTENSIONS_DIR=str(caches / "torch_extensions"), TRITON_CACHE_DIR=str(caches / "triton"),
                  TPUCLIP_HOME=workdir, TPUCLIP_INIT="random", USE_FLAX="0", USE_TF="0"):
            yield workdir
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _power_limit() -> Optional[str]:
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return done.stdout.strip().splitlines()[0] if done.returncode == 0 and done.stdout.strip() else None


def _measure(cell, state, seconds: float, trace: bool):
    """The window: the driver's calls back to back for ``seconds``."""
    import torch
    from bench_port.trace import CALL_SPAN, WINDOW_SPAN

    driver = cell.driver
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if state.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        span = record_function
    else:
        prof, span = contextlib.nullcontext(), lambda _name: contextlib.nullcontext()
    calls = items = 0
    with prof:
        with span(WINDOW_SPAN):
            start = time.perf_counter()
            deadline = start + seconds
            while True:
                with span(CALL_SPAN):
                    items += driver.call(state, calls)
                calls += 1
                if time.perf_counter() >= deadline:
                    break
            if state.device.type == "cuda":
                torch.cuda.synchronize(state.device)
            end = time.perf_counter()
    return start, Window(calls=calls, items=items, seconds=end - start), (prof if trace else None)


def run_cell(cell, seed: int, seconds: float, trace: bool, root: Path = Layout().root,
             device: str = "cuda", hook: Optional[Callable] = None, t0: Optional[float] = None) -> dict:
    """One run of ``cell`` (:func:`bench_port.spec.load_cell`); returns the
    result line as a dict. ``device`` other than ``cuda`` and ``hook``
    (called with the driver's state after set-up) are for the tests, which
    run the rest of a run on the CPU."""
    t_begin = T0 if t0 is None else t0
    timer = SetupTimer(t_begin)
    import torch

    timer.lap("import")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
    timer.lap("cuda_context")
    with program_home(root) as workdir:
        state = cell.driver.setup(cell, seed, dev, workdir, timer)
        if hook is not None:
            hook(state)
        start, window, prof = _measure(cell, state, seconds, trace)
        setup_s = start - t_begin
        log("[setup] " + " ".join(f"{k}={v:.3f}" for k, v in timer.parts) + f" total={setup_s:.3f}")
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": kind,
                       "count": 1, "memory_peak_bytes": int(peak)}
        metrics, breakdown = {}, None
        if trace:
            metrics, breakdown = _per_layer(cell, state, window, prof, kind, device_info)
        else:
            values = dict(cell.driver.end_to_end(state, window), setup_s=setup_s)
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        del prof
        limit = _power_limit() if dev.type == "cuda" else None
        log(f"[device] {kind}; nvidia-smi name, power.limit: {limit}; memory_peak_bytes {peak}")
        log(f"[window] calls={window.calls} items={window.items} seconds={window.seconds:.4f}")
        cell.driver.release(state)
        correct, failed, numbers = cell.driver.check(state, cell.limits)
    result = {"correct": bool(correct), "attempted": window.items, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = numbers
    return result


def _per_layer(cell, state, window: Window, prof, kind: str, device_info: dict):
    from bench_port import trace as tr

    timeline = tr.from_profiler(prof)
    peaks = json.loads((PKG / "peaks.json").read_text())
    ctx = TraceContext(timeline=timeline, images=window.items,
                       flops=cell.driver.window_flops(state, window.calls),
                       peak_flops=peaks.get(kind, {}).get("bf16_flops_per_s"))
    metrics = {}
    for m in cell.per_layer:
        value = cell.readers[m["name"]](ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    a, b = timeline.window
    device_info["busy_s"] = timeline.busy_ns(a, b) / 1e9
    device_info["window_s"] = timeline.window_s
    return metrics, {"device_ops": tr.device_ops(timeline), "idle_gaps": tr.idle_gaps(timeline)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = load_cell(args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"[error] this cell needs {chips} CUDA card(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, device_count={torch.cuda.device_count()}")
        return 2
    with contextlib.redirect_stdout(sys.stderr):
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"[error] the run loaded {found}; the benchmark may load none of {list(FORBIDDEN)}")
        return 3
    for name, n in result["check"].items():
        log(f"check {name} = {n['value']!r} (limit {n['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
