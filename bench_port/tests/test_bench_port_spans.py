"""The program's spans in a trace (``bench_port/spans.py``) and the four
readers built on them, on the CPU:

- the classification of raw events, a card-side copy of a span dropped;
- a synthetic trace of two calls with spans and launches gives each
  reader's value, worked out by hand, and each kernel its owner;
- the accepted readers, ``device_ops`` and the calls read the same with
  the program's spans as without; ``idle_gaps`` names the span open over a
  gap, and keeps today's labels where none is;
- a real profile of the tiny engine is found on the stack and parsed once;
- the tiny cells' traced runs with the four readers loaded by name.
"""

import json
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from conftest import DATA, ROOT, TINY, run_tiny

from bench_port import spans, trace
from bench_port.spec import Layout, load_cell

NEW = ["tower.attn_core_ms_per_image", "tower.attn_proj_ms_per_image", "tower.mlp_ms_per_image",
       "engine.stage_idle_ms_per_call"]
OLD = ["engine.host_gap_ms_per_call", "tower.device_ms_per_image", "index_mfu", "device_idle.index"]
IMAGES = 8


class Ev:
    """A raw profiler event as ``trace.from_profiler`` and
    ``spans.from_events`` read it."""

    def __init__(self, name, s, e, card=False, corr=0, thread=1):
        self._name, self._s, self._e, self._card, self._corr, self._thread = name, s, e, card, corr, thread

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return DeviceType.CUDA if self._card else DeviceType.CPU

    def start_thread_id(self):
        return self._thread

    def correlation_id(self):
        return self._corr


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))


def _call(t, c):
    """One call at host time ``t`` (400 ns long), correlation ids from
    ``c``: (program spans, other events). Inside the call: ``engine.stage``
    [10, 100) copies in, ``engine.forward`` [100, 200) launches a
    projection, the core, a LayerNorm outside any sublayer and the MLP,
    ``engine.fetch`` [200, 380) copies out."""
    program = [
        Ev("engine.stage", t + 10, t + 100), Ev("engine.forward", t + 100, t + 200),
        Ev("tower.attn", t + 110, t + 160), Ev("tower.attn.core", t + 120, t + 150),
        Ev("tower.mlp", t + 165, t + 190), Ev("engine.fetch", t + 200, t + 380),
    ]
    other = [
        Ev("bench.call", t, t + 400),
        Ev("aten::to", t + 20, t + 90), Ev("cudaMemcpyAsync", t + 30, t + 40, corr=c),
        Ev("Memcpy HtoD (Pageable -> Device)", t + 50, t + 85, card=True, corr=c),
        Ev("aten::linear", t + 112, t + 118), Ev("cudaLaunchKernel", t + 114, t + 116, corr=c + 1),
        Ev("aten::matmul", t + 124, t + 128), Ev("cudaLaunchKernel", t + 125, t + 127, corr=c + 2),
        Ev("aten::layer_norm", t + 161, t + 164), Ev("cudaLaunchKernel", t + 162, t + 163, corr=c + 3),
        Ev("aten::linear", t + 170, t + 175), Ev("cuLaunchKernelEx", t + 171, t + 173, corr=c + 4),
        Ev("aten::copy_", t + 205, t + 370), Ev("cudaMemcpyAsync", t + 206, t + 208, corr=c + 5),
        Ev("nvjet_proj", t + 120, t + 160, card=True, corr=c + 1),
        Ev("softmax_warp_forward", t + 160, t + 230, card=True, corr=c + 2),
        Ev("layer_norm_kernel", t + 230, t + 240, card=True, corr=c + 3),
        Ev("nvjet_mlp", t + 240, t + 300, card=True, corr=c + 4),
        Ev("Memcpy DtoH (Device -> Pageable)", t + 300, t + 320, card=True, corr=c + 5),
    ]
    return program, other


def _trace(with_spans=True, card_copies=False):
    """Two calls in a 1,000 ns window, in the order a profiler gives them
    (host events, then the card's)."""
    program, other = [], [Ev("bench.window", 0, 1000)]
    for t, c in ((100, 1), (500, 11)):
        p, o = _call(t, c)
        program += p
        other += o
    events = other + (program if with_spans else [])
    if card_copies:  # what a record_function span would leave on the card
        events += [Ev(ev.name(), ev.start_ns() + 40, ev.start_ns() + 200, card=True) for ev in program]
    return events


def _ctx(events, program=True):
    ctx = SimpleNamespace(timeline=trace.from_profiler(_prof(events)), images=IMAGES, flops=1e3, peak_flops=1e9)
    if program:
        ctx.program = spans.from_events(events)
    return ctx


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """The tiny cells' ``BENCHMARK.json`` with the four metrics added, as
    the root's has them."""
    root = tmp_path_factory.mktemp("bench")
    bench = json.loads((DATA / "BENCHMARK.json").read_text())
    root_metrics = {m["name"]: m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    bench["per_layer"] += [root_metrics[name] for name in NEW]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for c in bench["configs"]:
        shutil.copy(DATA / c["file"], root / c["file"])
    return Layout(root=root, traffic_dir=TINY.traffic_dir, limits_dir=TINY.limits_dir)


@pytest.fixture(scope="module")
def read(layout):
    """``read(names, ctx)``: each reader's value, the readers found by name."""
    readers = load_cell("tiny.224", layout).readers
    return lambda names, ctx: {name: readers[name](ctx) for name in names}


@pytest.mark.parametrize("event, want", [
    (("engine.stage", False), "span"), (("tower.attn.core", False), "span"), (("scan.inference", False), "span"),
    (("search.db_query", False), "span"), (("bench.call", False), "bench"), (("bench.window", False), "bench"),
    (("aten::to", False), "op"), (("cudaLaunchKernel", False), "op"),
    (("tower.attn", True), "annotation"), (("engine.stage", True), "annotation"), (("bench.call", True), "annotation"),
    (("Memcpy HtoD (Pageable -> Device)", True), "copy"), (("Memset (Device)", True), "copy"),
    (("nvjet_tst_192x192", True), "kernel"), (("void at::native::elementwise_kernel", True), "kernel"),
])
def test_classify(event, want):
    assert spans.classify(*event) == want


def test_owners_and_nesting():
    p = spans.from_events(_trace())
    assert [(name, depth) for _, _, name, depth in p.spans[:6]] == [
        ("engine.stage", 0), ("engine.forward", 0), ("tower.attn", 1), ("tower.attn.core", 2), ("tower.mlp", 1),
        ("engine.fetch", 0)]
    owners = [p.owner(launch) for _, _, _, launch in p.kernels]
    assert owners == ["tower.attn", "tower.attn.core", "engine.forward", "tower.mlp"] * 2
    assert p.owner(None) is None and p.owner(105) is None and p.owner(130) == "engine.stage"
    assert p.kernel_ns_by_owner((0, 1000)) == {"tower.attn": 80, "tower.attn.core": 140, "engine.forward": 20,
                                               "tower.mlp": 120}
    assert p.kernel_ns_by_owner((0, 500)) == {"tower.attn": 40, "tower.attn.core": 70, "engine.forward": 10,
                                              "tower.mlp": 60}


def test_readers_on_a_synthetic_trace(read):
    got = read(NEW + OLD, _ctx(_trace()))
    ms = 1e-6
    assert got["tower.attn_core_ms_per_image"] == pytest.approx(140 / IMAGES * ms)
    assert got["tower.attn_proj_ms_per_image"] == pytest.approx(80 / IMAGES * ms)
    assert got["tower.mlp_ms_per_image"] == pytest.approx(120 / IMAGES * ms)
    # engine.stage [10, 100) of each call: the copy in covers [50, 85)
    assert got["engine.stage_idle_ms_per_call"] == pytest.approx(55 * ms)
    # the three tower metrics are parts of tower.device_ms_per_image
    parts = sum(got[n] for n in NEW[:3])
    assert parts < got["tower.device_ms_per_image"] == pytest.approx(360 / IMAGES * ms)
    # a kernel whose launch is not on the main thread has no owner
    events = [Ev(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), thread=2, corr=e.correlation_id())
              if e.name() == "cuLaunchKernelEx" else e for e in _trace()]
    assert read(["tower.mlp_ms_per_image"], _ctx(events)) == {"tower.mlp_ms_per_image": 0.0}


def test_accepted_readings_are_the_same_with_and_without_spans(read):
    with_spans, without = _ctx(_trace(), program=False), _ctx(_trace(with_spans=False), program=False)
    for field in ("window", "calls", "kernels", "copies", "busy"):
        assert getattr(with_spans.timeline, field) == getattr(without.timeline, field)
    assert read(OLD, with_spans) == read(OLD, without)
    assert trace.device_ops(with_spans.timeline) == trace.device_ops(without.timeline)
    # without spans the program trace is None and the new readers report nothing
    assert read(NEW, without) == dict.fromkeys(NEW)
    # a gap inside a span is named by it; between calls the label is as before
    gaps = dict(trace.idle_gaps(with_spans.timeline, top=100))
    before = dict(trace.idle_gaps(without.timeline, top=100))
    assert gaps["call/engine.stage"] > 0 and "call/engine.stage" not in before and before["call/aten::to"] > 0
    assert gaps["between_calls/python"] == before["between_calls/python"]
    assert sum(gaps.values()) == pytest.approx(sum(before.values()))


def test_card_side_copies_of_spans_are_dropped(read):
    """A span recorded as a user annotation leaves a copy on the card,
    which ``trace.py`` counts as a kernel: the accepted readings move. The
    program trace drops it: its kernels and owners read the same."""
    plain, copied = _trace(), _trace(card_copies=True)
    assert read(OLD, _ctx(copied, False)) != read(OLD, _ctx(plain, False))
    assert spans.from_events(copied).kernels == spans.from_events(plain).kernels
    assert read(NEW[:3], _ctx(copied)) == read(NEW[:3], _ctx(plain))


def _per_layer_like(prof):
    """Holds the profile as a local, as ``run._per_layer`` does, while a
    reader looks for it."""
    ctx = SimpleNamespace(timeline=trace.from_profiler(prof), images=IMAGES)
    first = spans.program_trace(ctx)
    return ctx, first, spans.program_trace(ctx)


def test_a_real_profile_is_found_on_the_stack(read, tmp_path, monkeypatch):
    import tpuclip_torch.engine as pt_engine

    monkeypatch.setenv("TPUCLIP_HOME", str(tmp_path))
    monkeypatch.setenv("TPUCLIP_INIT", "random")
    engine = pt_engine.ImageDatabase(str(tmp_path / "t.db"), str(tmp_path / "models"), model_name="tpuclip/test-tiny",
                                     inference_batch_size=2, device="cpu")
    pixels = np.zeros((2, 56, 56, 3), np.uint8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            for _ in range(2):
                with record_function("bench.call"):
                    engine.embed_images_uint8(pixels)
    ctx, first, again = _per_layer_like(prof)
    assert first is again is ctx.program
    names = [name for _, _, name, _ in first.spans]
    assert names.count("engine.stage") == names.count("engine.fetch") == 2
    assert names.count("tower.attn.core") == 2 * 3  # two layers and the head, each call
    assert {depth for _, _, name, depth in first.spans if name.startswith("engine.")} == {0}
    assert first.kernels == []  # no card: no kernel, and no device reading
    assert read(NEW, ctx) == dict.fromkeys(NEW)
    del prof
    # program spans in the timeline and no profile on the stack: loud, not silent
    with pytest.raises(RuntimeError, match="no profile was found"):
        spans.program_trace(SimpleNamespace(timeline=ctx.timeline))
    # a timeline without program spans (a program without them): nothing to read
    plain = trace.from_profiler(_prof(_trace(with_spans=False)))
    assert spans.program_trace(SimpleNamespace(timeline=plain)) is None


@pytest.mark.parametrize("workload", ["tiny.224", "tiny.naflex"])
def test_tiny_traced_run_loads_the_new_readers(workload, layout, tmp_path, monkeypatch):
    import conftest

    monkeypatch.setattr(conftest, "TINY", layout)
    assert set(NEW) <= set(load_cell(workload, layout).readers)
    result, _ = run_tiny(workload, tmp_path, trace=True)
    assert result["correct"] is True
    assert result["metrics"] == {}  # no card: no device reading
    labels = [label for label, _ in result["breakdown"]["idle_gaps"]]
    assert all(label.split("/")[0] in ("call", "between_calls") for label in labels)
