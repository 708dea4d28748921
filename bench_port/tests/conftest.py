"""Helpers for the benchmark's own tests: tiny cells (``data/``) that run the
harness end to end on the CPU, at the program's tiny presets.

Run with ``python3 -m pytest bench_port/tests -q`` from the checkout's root;
the tests marked ``cuda`` run on a card and skip without one.
"""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port.spec import PKG, Layout, load_cell  # noqa: E402

DATA = PKG / "tests" / "data"
TINY = Layout(root=DATA, traffic_dir=DATA / "traffic", limits_dir=DATA / "limits")
TINY_CELLS = ["tiny.224", "tiny.naflex"]


def run_tiny(workload, tmp_path, seed=2**31 + 5, seconds=0.3, trace=False, hook=None):
    """One run of a tiny cell on the CPU; returns (result, driver state)."""
    from bench_port import run

    seen = {}

    def keep(state):
        seen["state"] = state
        if hook is not None:
            hook(state)

    cell = load_cell(workload, TINY)
    result = run.run_cell(cell, seed, seconds, trace, root=tmp_path, device="cpu", hook=keep,
                          t0=time.perf_counter())
    return result, seen["state"]


def plant_control(state):
    """Puts the control, the reference in fp8 (``siglip_ref.FP8``) from the
    benchmark's own weights, in the place of the engine's entry."""
    import numpy as np

    from bench_port import weights
    from bench_port.reference import siglip_ref

    w32 = siglip_ref.fp32_weights(weights.make_vision_weights(state.shape, state.seed, state.device, state.dtype))
    keys = ("patches", "masks", "grids") if state.shape.naflex else ("pixels",)

    def control(*arrays):
        rows = np.arange(len(arrays[0]))
        return siglip_ref.reference_rows(w32, dict(zip(keys, arrays)), rows, state.shape,
                                         siglip_ref.FP8()).cpu().numpy()
    state.entry = control


@pytest.fixture
def card():
    """Skips the test without a CUDA card (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
