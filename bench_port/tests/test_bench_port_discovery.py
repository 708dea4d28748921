"""Cells, traffic mixes, limits and metric readers are found by name, and
``BENCHMARK.json`` keeps to the benchmark's contract (keys, names, units,
bounds, lengths, the files under ``paths``)."""

import json
import re
import shutil

import pytest

from conftest import ROOT, TINY

from bench_port.shapes import vision_shape
from bench_port.spec import PKG, Layout, load_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["bench_port"]
    assert BENCH["command"][:3] == ["python3", "-m", "bench_port.run"] and len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_entries_keep_to_the_contract():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"}}
    for group, want in keys.items():
        for entry in BENCH[group]:
            assert set(entry) == want, entry
            assert NAME.match(entry["name"]) and 1 <= len(entry["why"]) <= 200
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("bench_port/")
        assert c["reduced"] == [] and c["source"].startswith("https://")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and NAME.match(w["traffic"]) and NAME.match(w["config"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]} and "\n" not in m["layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in BENCH["end_to_end"]} == {"index_images_per_s", "setup_s"}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_is_found_by_name(workload):
    cell = load_cell(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.traffic["driver"] == "embed" and cell.limits["max_row_dist"] > 0
    assert {m["name"] for m in cell.end_to_end} == {"index_images_per_s", "setup_s"}
    assert set(cell.readers) == {m["name"] for m in BENCH["per_layer"]}
    assert all(callable(r) for r in cell.readers.values())


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_the_programs_preset_is_the_configuration(name):
    """The preset that the engine loads has the published widths."""
    from tpuclip_torch.models.configs import get_config

    config = json.loads((ROOT / f"bench_port/configs/{name}.json").read_text())
    shape, v = vision_shape(config), get_config(config["preset"]).vision
    assert (v.hidden_size, v.intermediate_size, v.num_layers, v.num_heads, v.patch_size, v.naflex) == (
        shape.hidden, shape.mlp, shape.layers, shape.heads, shape.patch, shape.naflex)
    assert v.num_patches == shape.tokens == 256
    assert config["compute_dtype"] == "bfloat16"


def test_a_new_cell_is_new_files_only(tmp_path):
    """A configuration, a mix, a limit and a metric added as files and
    entries, without editing a file that is there."""
    root = tmp_path / "root"
    shutil.copytree(TINY.root, root)
    metrics = tmp_path / "metrics"
    shutil.copytree(PKG / "metrics", metrics)
    (metrics / "calls_per_s.py").write_text("def read(ctx):\n    return len(ctx.timeline.calls)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-224b", "source": "x", "file": "tiny-224b.json", "reduced": [], "why": "x"})
    config = json.loads((root / "tiny-224.json").read_text())
    config["name"] = "tiny-224b"
    (root / "tiny-224b.json").write_text(json.dumps(config))
    traffic = json.loads((root / "traffic" / "t8.json").read_text())
    traffic["batch"] = traffic["inference_batch_size"] = 4
    (root / "traffic" / "t4.json").write_text(json.dumps(traffic))
    bench["workloads"].append({"name": "tiny.224b", "config": "tiny-224b", "traffic": "t4", "chips": 1, "why": "x"})
    (root / "limits" / "tiny.224b.json").write_text('{"max_row_dist": 0.05}')
    bench["per_layer"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher", "source": "device_trace",
                               "layer": "engine", "moves": "index_images_per_s", "workloads": ["tiny.224b"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    layout = Layout(root=root, traffic_dir=root / "traffic", limits_dir=root / "limits", metrics_dir=metrics)
    cell = load_cell("tiny.224b", layout)
    assert cell.traffic["batch"] == 4 and "calls_per_s" in cell.readers
    assert "calls_per_s" not in load_cell("tiny.224", layout).readers


def test_missing_pieces_raise(tmp_path):
    layout = Layout(root=TINY.root, traffic_dir=TINY.traffic_dir, limits_dir=tmp_path)
    with pytest.raises(FileNotFoundError):
        load_cell("tiny.224", layout)
    with pytest.raises(KeyError):
        load_cell("no.such.cell", TINY)
