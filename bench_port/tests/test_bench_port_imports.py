"""A run loads neither ``jax`` nor the JAX package ``tpuclip``, compared by
whole top-level module names (``tpuclip_torch`` is the program and is
allowed); the plain reference loads nothing of the program either."""

import json
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "tpuclip"}

RUN_A_TINY_CELL = """
import json, sys, tempfile, time
from pathlib import Path
sys.path.insert(0, {tests!r})
from conftest import run_tiny
run_tiny("tiny.naflex", Path(tempfile.mkdtemp()), trace=True)
run_tiny("tiny.224", Path(tempfile.mkdtemp()))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

IMPORT_THE_REFERENCE = """
import json, sys
import bench_port.reference.siglip_ref, bench_port.weights, bench_port.shapes, bench_port.flops
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level_modules(code):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=env)
    assert done.returncode == 0, done.stderr[-3000:]
    return set(json.loads(done.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_tpuclip():
    loaded = _top_level_modules(RUN_A_TINY_CELL.format(tests=str(ROOT / "bench_port" / "tests")))
    assert "tpuclip_torch" in loaded and "bench_port" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level_modules(IMPORT_THE_REFERENCE)
    assert not loaded & (FORBIDDEN | {"tpuclip_torch"})


def test_the_harness_checks_whole_names():
    from bench_port import run

    saved = dict(sys.modules)
    try:
        sys.modules["tpuclip_torch_fake"] = sys
        sys.modules["jaxlike"] = sys
        assert run.forbidden_modules() == sorted(set(run.FORBIDDEN) & {m.split(".")[0] for m in saved})
        sys.modules["tpuclip.fake"] = sys
        assert "tpuclip" in run.forbidden_modules()
    finally:
        for k in ("tpuclip_torch_fake", "jaxlike", "tpuclip.fake"):
            sys.modules.pop(k, None)
