"""The port's spans (``tpuclip_torch.utils.profiling.span``) on the CPU:

- without a profiler a span records nothing (one shared no-op context);
- under ``torch.profiler`` one embedding call of each tiny preset records
  the engine's steps and the tower's sublayers, nested and in order:
  ``engine.stage``, ``engine.forward`` (``tower.patch``; per layer
  ``tower.attn`` around ``tower.attn.core``, then ``tower.mlp``;
  ``tower.head`` around the head's own attention and MLP), ``engine.fetch``;
  the text tower shares the layer spans;
- the spans are host events in the profiler's function scope, not user
  annotations, so they leave no copy on a card's timeline;
- embeddings are bit-equal with the profiler on and off;
- the scan's timers open ``scan.<op>``; the search's open none;
- the three private profiler symbols the port relies on still exist, so a
  torch upgrade that renames one fails here, in one place.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpuclip_torch.engine as pt_engine
from tpuclip_torch.models.configs import get_config
from tpuclip_torch.utils import profiling
from tpuclip_torch.utils.profiling import StepTimers, Timings, span

PREFIXES = ("engine.", "tower.", "scan.", "search.")
BATCH = 4


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trace")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUCLIP_HOME", str(tmp / "home"))
        yield {
            model: pt_engine.ImageDatabase(str(tmp / f"{i}.db"), str(tmp / "models"), model_name=model,
                                           inference_batch_size=BATCH, device="cpu")
            for i, model in enumerate(("tpuclip/test-tiny", "tpuclip/test-tiny-naflex"))
        }


def _inputs(engine, rows=3, seed=11):
    """``rows`` seeded images for the engine's image entry (under the
    inference batch, so the call pads)."""
    rng = np.random.default_rng(seed)
    v = engine.config.vision
    if not v.naflex:
        return engine.embed_images_uint8, (rng.integers(0, 256, (rows, v.image_size, v.image_size, 3), np.uint8),)
    grids = np.array([(8, 8), (4, 8), (8, 6)] * rows, np.int32)[:rows]
    length = v.max_num_patches
    masks = (np.arange(length)[None, :] < (grids[:, 0] * grids[:, 1])[:, None]).astype(np.int32)
    patches = rng.integers(0, 256, (rows, length, v.patch_size**2 * v.num_channels), np.uint8)
    return engine.embed_patches_naflex, (patches * masks[:, :, None].astype(np.uint8), masks, grids)


def _spans(prof):
    """[(depth, name)] of the program's spans in start order; depth counts
    enclosing program spans only (operators between them are skipped)."""
    out = []
    for ev in sorted(prof.events(), key=lambda e: e.time_range.start):
        if not ev.name.startswith(PREFIXES):
            continue
        depth, parent = 0, ev.cpu_parent
        while parent is not None:
            depth += parent.name.startswith(PREFIXES)
            parent = parent.cpu_parent
        out.append((depth, ev.name))
    return out


def _layer(depth):
    return [(depth, "tower.attn"), (depth + 1, "tower.attn.core"), (depth, "tower.mlp")]


def test_span_without_a_profiler_records_nothing(monkeypatch):
    entered = []

    class Recorder:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(profiling, "_RecordFunctionFast", Recorder)
    with span("engine.stage"), span("tower.mlp"):
        pass
    assert entered == [] and span("a") is span("b")
    with profile(activities=[ProfilerActivity.CPU]):
        with span("engine.stage"):
            pass
    assert entered == ["engine.stage"]


@pytest.mark.parametrize("model", ["tpuclip/test-tiny", "tpuclip/test-tiny-naflex"])
def test_embedding_call_records_the_spans_in_order(engines, model):
    engine = engines[model]
    entry, args = _inputs(engine)
    entry(*args)  # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        entry(*args)
    layers = get_config(model).vision.num_layers
    tower = [(1, "tower.patch")] + _layer(1) * layers + [(1, "tower.head")] + _layer(2)
    assert _spans(prof) == [(0, "engine.stage"), (0, "engine.forward")] + tower + [(0, "engine.fetch")]
    names = {name for _, name in _spans(prof)}
    events = [ev for ev in prof.profiler.kineto_results.events() if ev.name() in names]
    assert events and not any(ev.is_user_annotation() for ev in events)


def test_text_tower_shares_the_layer_spans(engines):
    engine = engines["tpuclip/test-tiny"]
    engine.embed_texts(["a red car"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.embed_texts(["a red car", "a dog"])
    assert _spans(prof) == _layer(0) * get_config("tpuclip/test-tiny").text.num_layers


@pytest.mark.parametrize("model", ["tpuclip/test-tiny", "tpuclip/test-tiny-naflex"])
def test_embeddings_bit_equal_with_the_profiler_on_and_off(engines, model):
    entry, args = _inputs(engines[model], rows=BATCH + 2, seed=12)  # a full chunk and a padded one
    off = entry(*args)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = entry(*args)
    assert [name for _, name in _spans(prof)].count("engine.forward") == 2
    np.testing.assert_array_equal(on, off)


def test_timers_open_their_spans():
    steps, timings = StepTimers(), Timings()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with steps.track("inference", count=3):
            torch.ones(4).sum()
        with timings.track("db_query"):
            torch.ones(4).sum()
    assert [name for _, name in _spans(prof)] == ["scan.inference"]
    assert steps.counts["inference"] == 3 and steps.totals["inference"] > 0
    assert timings.timings["db_query"] > 0


def test_the_private_profiler_symbols_exist():
    """``span`` enters ``torch._C._profiler._RecordFunctionFast`` on the
    module flag ``torch.autograd.profiler._is_profiler_enabled``; the scan's
    trace records every thread through ``_ExperimentalConfig``."""
    import torch.autograd.profiler as autograd_profiler
    from torch._C._profiler import _ExperimentalConfig, _RecordFunctionFast

    assert autograd_profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert autograd_profiler._is_profiler_enabled is True
        with _RecordFunctionFast("engine.stage"):
            torch.ones(2).sum()
    assert autograd_profiler._is_profiler_enabled is False
    assert [name for _, name in _spans(prof)] == ["engine.stage"]
    _ExperimentalConfig(profile_all_threads=True)


def test_scan_trace_holds_the_timed_steps(engines, tmp_path, monkeypatch):
    """``scan --profile`` with ``TPUCLIP_TRACE_DIR``: the exported trace
    holds the timers' steps and the tower's spans."""
    from PIL import Image

    rng = np.random.default_rng(13)
    root = tmp_path / "imgs"
    root.mkdir()
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), np.uint8)).save(root / f"img_{i}.png")
    monkeypatch.setenv("TPUCLIP_TRACE_DIR", str(tmp_path / "trace"))
    engines["tpuclip/test-tiny"].scan_directory(str(root), inference_batch_size=BATCH, profile=True)
    events = json.loads((tmp_path / "trace" / "scan_trace.json").read_text())["traceEvents"]
    names = {ev.get("name") for ev in events}
    assert {"scan.check_db", "scan.db_write", "scan.inference", "tower.patch", "tower.attn.core"} <= names
