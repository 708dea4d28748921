"""The harness end to end on tiny cells, on the CPU: a run's result line, a
traced run, the faults that have to turn ``correct`` false, the control,
and the refusals (no card; a checkout that holds only the benchmark)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY, TINY_CELLS, plant_control, run_tiny

from bench_port.reference import siglip_ref
from bench_port.spec import load_cell


@pytest.mark.parametrize("workload", TINY_CELLS)
def test_tiny_cell_result_line(workload, tmp_path):
    result, state = run_tiny(workload, tmp_path)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] == len(state.outputs) * state.batch > 0
    assert set(result["metrics"]) == {"index_images_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    check = result["check"]
    assert 0 < check["max_row_dist"]["value"] <= check["max_row_dist"]["limit"]
    assert check["bad_rows"] == {"value": 0, "limit": 0}
    # the window cycles the pool, and every row it returned was compared
    assert {s for s, _ in state.outputs} <= set(range(0, state.pool_size, state.batch))


@pytest.mark.parametrize("workload", TINY_CELLS)
def test_same_seed_same_inputs_and_answers(workload, tmp_path):
    a, sa = run_tiny(workload, tmp_path, seed=2**33 + 1)
    b, sb = run_tiny(workload, tmp_path, seed=2**33 + 1)
    for k in sa.pool:
        np.testing.assert_array_equal(sa.pool[k], sb.pool[k])
    np.testing.assert_array_equal(sa.outputs[0][1], sb.outputs[0][1])
    c, sc = run_tiny(workload, tmp_path, seed=7)
    key = next(iter(sa.pool))
    assert not np.array_equal(sa.pool[key], sc.pool[key])


@pytest.mark.parametrize("workload", TINY_CELLS)
def test_traced_run(workload, tmp_path):
    result, _ = run_tiny(workload, tmp_path, trace=True)
    assert result["correct"] is True
    assert list(result)[-2:] == ["breakdown", "check"]
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # no card: no device interval, so every device metric is left out
    assert result["metrics"] == {}
    assert all(label.split("/")[0] in ("call", "between_calls") for label, _ in result["breakdown"]["idle_gaps"])


def _stale(model, name):
    """A call that returns its output buffer unchanged: the previous call's
    rows (zeros, as allocated, before the first)."""
    real, last = getattr(model, name), {}

    def broken(*args):
        fresh = real(*args)
        out = last.get("out", torch.zeros_like(fresh))
        last["out"] = fresh
        return out
    setattr(model, name, broken)


def _half(model, name):
    """Half of the batch left out: its rows are the mean of the rest."""
    real = getattr(model, name)

    def broken(*args):
        out = real(*args).clone()
        h = len(out) // 2
        out[h:] = out[:h].mean(0) / out[:h].mean(0).norm()
        return out
    setattr(model, name, broken)


def _altered(model, name):
    """One answer altered where it is produced: row 0 is row 1's."""
    real = getattr(model, name)

    def broken(*args):
        out = real(*args).clone()
        out[0] = out[1]
        return out
    setattr(model, name, broken)


@pytest.mark.parametrize("fault", [_stale, _half, _altered], ids=["stale", "half", "altered"])
@pytest.mark.parametrize("workload", TINY_CELLS)
def test_a_broken_tower_is_not_correct(workload, fault, tmp_path):
    def plant(state):
        name = "get_image_features_naflex" if state.shape.naflex else "get_image_features"
        fault(state.engine.model, name)

    result, _ = run_tiny(workload, tmp_path, hook=plant, seconds=0.5)
    assert result["correct"] is False
    assert result["failed"] > 0
    assert result["check"]["max_row_dist"]["value"] > result["check"]["max_row_dist"]["limit"]


@pytest.mark.parametrize("workload", TINY_CELLS)
def test_the_control_fails_the_limit(workload, tmp_path):
    """The reference computed in fp8 (the control) in the program's place
    reads over the cell's limit; the program (bf16) reads under it."""
    result, state = run_tiny(workload, tmp_path, seconds=0.1)
    driver = load_cell(workload, TINY).driver
    exact = driver.reference(state)
    low = driver.reference(state, siglip_ref.FP8())
    control = float(np.linalg.norm(low.astype(np.float64) - exact, axis=1).max())
    limit = result["check"]["max_row_dist"]["limit"]
    assert result["check"]["max_row_dist"]["value"] < limit < control


@pytest.mark.parametrize("workload", TINY_CELLS)
def test_the_control_in_the_programs_place_is_not_correct(workload, tmp_path):
    """The control as the engine's entry: the harness's window and check
    read ``correct`` false, the worst row over the limit."""
    result, _ = run_tiny(workload, tmp_path, hook=plant_control, seconds=0.3)
    worst = result["check"]["max_row_dist"]
    assert result["correct"] is False and result["failed"] > 0
    assert result["check"]["bad_rows"]["value"] == 0 and worst["value"] > worst["limit"]


def test_cli_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine without one")
    done = subprocess.run([sys.executable, "-m", "bench_port.run", "--workload", "embed.so400m-224.b256",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout.strip() == ""


def test_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    """BENCHMARK.json and bench_port/ alone: no program, so no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; from bench_port import run; from bench_port.spec import load_cell\n"
            "cell = load_cell('embed.so400m-224.b256')\n"
            "print(run.run_cell(cell, 1, 0.1, False, device='cpu', t0=time.perf_counter()))\n")
    env = dict(os.environ, PYTHONPATH="")
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300, env=env)
    assert done.returncode != 0 and done.stdout.strip() == ""
    assert "tpuclip_torch" in done.stderr


def test_result_line_is_json(tmp_path):
    result, _ = run_tiny("tiny.224", tmp_path)
    assert json.loads(json.dumps(result)) == result


def test_mix_check_windows_each_family(tmp_path):
    """``mix_check`` times the mix, each family alone, then the mix again,
    with every pool image of a family on that family's grid."""
    from bench_port import mix_check

    cell = load_cell("tiny.naflex", TINY)
    lines = list(mix_check.windows(cell, 2**31 + 9, 0.05, torch.device("cpu"), tmp_path, None))
    families = [s["aspect"] for s in cell.traffic["naflex_sources"]]
    assert [x["traffic"] for x in lines] == ["mix", *families, "mix"]
    assert all(x["calls"] >= 1 and x["index_images_per_s"] > 0 for x in lines)
    assert lines[0]["mean_real_patches"] == lines[-1]["mean_real_patches"]
    assert len({x["mean_real_patches"] for x in lines[1:-1]}) > 1
