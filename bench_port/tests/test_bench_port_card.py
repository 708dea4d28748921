"""On a card: every cell of ``BENCHMARK.json`` runs once through its
command, short, and is correct; the fp8 control fails each cell's limit on
the cell's own pool; and the control put in the program's place, through
the harness's own window and check, reads ``correct`` false. Marked
``cuda``; skips without a card.

    python3 -m pytest bench_port/tests -q -m cuda
"""

import json
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT, plant_control

from bench_port import run
from bench_port.spec import load_cell

WORKLOADS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_correct_on_the_card(workload, card):
    done = subprocess.run([sys.executable, "-m", "bench_port.run", "--workload", workload,
                           "--seed", str(2**31 + 101), "--seconds", "2", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-3000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails_on_the_card(workload, card):
    done = subprocess.run([sys.executable, "-m", "bench_port.calibrate", "--workload", workload,
                           "--seeds", "3", "--control-seeds", "4", "--seconds", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-3000:]
    summary = json.loads(done.stdout.strip().splitlines()[-1])
    limit = json.loads((ROOT / f"bench_port/limits/{workload}.json").read_text())["max_row_dist"]
    assert summary["program_max"] < limit < summary["control_min"]
    assert np.isfinite(summary["control_min"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_in_the_programs_place_is_not_correct(workload, card, tmp_path):
    """The fp8 reference as the engine's entry, at the cell's own batch and
    pool: the run's window and ``driver.check`` find it over the limit."""
    result = run.run_cell(load_cell(workload), 2**31 + 303, 1.0, False, root=tmp_path, hook=plant_control)
    worst = result["check"]["max_row_dist"]
    assert result["correct"] is False and result["failed"] > 0
    assert result["attempted"] >= 256 and result["check"]["bad_rows"]["value"] == 0
    assert np.isfinite(worst["value"]) and worst["value"] > worst["limit"]
