"""The port's ``selftest`` against tpuclip's, on the CPU.

``run_selftest`` of both packages on the synthetic real-format artifacts of
``tests/test_checkpoint_drill.py`` (a genuine ``save_pretrained``
safetensors directory and a sentencepiece ``tokenizer.model``): the same
step names and statuses in the same order, on the passing drill, the cache
lookup, an empty cache, a missing tokenizer and wrong weights behind the HF
oracle (the parity step must FAIL in both). The port's parity step compares
its own towers (fp32, CPU) with ``transformers``' ``SiglipModel``. Then
``run_e2e_selftest`` of both on the bundled tree with the tiny model at
random init, and the CLI's exit codes. No step reaches the network."""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from test_checkpoint_drill import (  # noqa: E402
    MODEL_NAME,
    TEXT_KW,
    VISION_KW,
    _gemma_style_tokenizer_model,
)

import tpuclip.cli as jx_cli  # noqa: E402
import tpuclip.selftest as jx_selftest  # noqa: E402
import tpuclip_torch.cli as pt_cli  # noqa: E402
import tpuclip_torch.selftest as pt_selftest  # noqa: E402
from tpuclip.text import sentencepiece as sp  # noqa: E402

PACKAGES = {"port": pt_selftest, "tpuclip": jx_selftest}


def _hf_config():
    return transformers.SiglipConfig.from_text_vision_configs(
        transformers.SiglipTextConfig(**TEXT_KW), transformers.SiglipVisionConfig(**VISION_KW)
    )


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("pt_selftest_ckpt")
    torch.manual_seed(7)
    transformers.SiglipModel(_hf_config()).eval().save_pretrained(
        str(d), safe_serialization=True, max_shard_size="200KB")
    (d / "tokenizer.model").write_bytes(sp.serialize_model(_gemma_style_tokenizer_model()))
    return d


def _steps(report):
    return [(s.name, s.status) for s in report.steps]


def _both(tmp_path, **kwargs):
    """run_selftest of each package, each converting into its own dir."""
    reports = {}
    for name, mod in PACKAGES.items():
        extra = {"device": "cpu"} if name == "port" else {}
        reports[name] = mod.run_selftest(
            model_name=MODEL_NAME, allow_download=False,
            convert_dst=str(tmp_path / f"converted_{name}"), **kwargs, **extra)
    assert _steps(reports["port"]) == _steps(reports["tpuclip"])
    assert reports["port"].ok == reports["tpuclip"].ok
    return reports["port"]


def test_drill_passes_like_tpuclip(hf_dir, tmp_path):
    report = _both(tmp_path, model_cache_dir=str(tmp_path / "cache"), source=str(hf_dir))
    assert _steps(report) == [("locate", "PASS"), ("load", "PASS"), ("convert", "PASS"),
                              ("tokenizer", "PASS"), ("tokenizer_oracle", "SKIP"), ("parity", "PASS")]
    assert report.ok and report.summary() == "SELFTEST PASS (5 passed, 0 failed, 1 skipped)"
    # Either package's converted checkpoint loads in the other with equal leaves.
    from tpuclip.models.checkpoint import load_checkpoint as jx_load
    from tpuclip_torch.models.checkpoint import load_checkpoint as pt_load

    for load in (pt_load, jx_load):
        (ca, pa), (cb, pb) = load(str(tmp_path / "converted_port")), load(str(tmp_path / "converted_tpuclip"))
        assert ca == cb
        fa, fb = pt_selftest._flatten(pa), pt_selftest._flatten(pb)
        assert sorted(fa) == sorted(fb)
        for k in fa:
            np.testing.assert_array_equal(np.asarray(fa[k], np.float32), np.asarray(fb[k], np.float32))


def test_parity_cosine_is_near_one(hf_dir, tmp_path):
    report = pt_selftest.run_selftest(
        model_name=MODEL_NAME, model_cache_dir=str(tmp_path / "cache"), source=str(hf_dir),
        allow_download=False, convert_dst=str(tmp_path / "c"), device="cpu")
    parity = next(s for s in report.steps if s.name == "parity")
    cosines = [float(x.split()[-1].rstrip(",")) for x in parity.detail.split(" (")[0].split(", ")]
    assert parity.status == "PASS" and min(cosines) >= 0.9999, parity.detail


def test_cache_lookup_like_tpuclip(hf_dir, tmp_path):
    cache = tmp_path / "cache"
    shutil.copytree(hf_dir, cache / MODEL_NAME.replace("/", "--"))
    report = _both(tmp_path, model_cache_dir=str(cache), skip_parity=True)
    assert ("locate", "PASS") in _steps(report) and ("parity", "SKIP") in _steps(report)
    assert report.ok


def test_nothing_to_load_like_tpuclip(tmp_path):
    report = _both(tmp_path, model_cache_dir=str(tmp_path / "empty"))
    assert _steps(report) == [("locate", "FAIL")] and not report.ok


def test_source_without_config_like_tpuclip(tmp_path):
    (tmp_path / "nocfg").mkdir()
    report = _both(tmp_path, model_cache_dir=str(tmp_path / "cache"), source=str(tmp_path / "nocfg"))
    assert _steps(report) == [("locate", "FAIL")]


def test_missing_tokenizer_fails_like_tpuclip(hf_dir, tmp_path):
    bare = tmp_path / "bare"
    shutil.copytree(hf_dir, bare)
    (bare / "tokenizer.model").unlink()
    report = _both(tmp_path, model_cache_dir=str(tmp_path / "cache"), source=str(bare), skip_parity=True)
    assert ("tokenizer", "FAIL") in _steps(report) and not report.ok


def test_wrong_weights_fail_parity_like_tpuclip(hf_dir, tmp_path, monkeypatch):
    """The HF oracle redirected to a reseeded model of the same config: the
    parity step must FAIL in both packages."""
    torch.manual_seed(99)
    reseeded = tmp_path / "reseeded"
    transformers.SiglipModel(_hf_config()).eval().save_pretrained(str(reseeded), safe_serialization=True)
    real = transformers.SiglipModel.from_pretrained.__func__
    monkeypatch.setattr(transformers.SiglipModel, "from_pretrained",
                        classmethod(lambda cls, path, *a, **k: real(cls, str(reseeded), *a, **k)))
    report = _both(tmp_path, model_cache_dir=str(tmp_path / "cache"), source=str(hf_dir))
    assert ("parity", "FAIL") in _steps(report) and not report.ok


def test_parity_skips_without_transformers(hf_dir, tmp_path, monkeypatch):
    """Where ``transformers`` does not import, the parity step is a SKIP
    with a reason, in both packages."""
    import builtins

    real_import = builtins.__import__

    def no_transformers(name, *a, **k):
        if name == "transformers" or name.startswith("transformers."):
            raise ImportError("No module named 'transformers'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_transformers)
    report = _both(tmp_path, model_cache_dir=str(tmp_path / "cache"), source=str(hf_dir))
    parity = next(s for s in report.steps if s.name == "parity")
    assert parity.status == "SKIP" and "oracle unavailable" in parity.detail and report.ok


def test_e2e_product_smoke_like_tpuclip(tmp_path, monkeypatch):
    """``run_e2e_selftest`` with the tiny model at random init on the CPU:
    every step PASS in both, with the same steps."""
    monkeypatch.setenv("TPUCLIP_HOME", str(tmp_path / "home"))
    reports = {}
    for name, mod in PACKAGES.items():
        extra = {"device": "cpu"} if name == "port" else {}
        reports[name] = mod.run_e2e_selftest("tpuclip/test-tiny", str(tmp_path / "cache"),
                                             work_dir=str(tmp_path / f"work_{name}"), **extra)
    assert _steps(reports["port"]) == _steps(reports["tpuclip"])
    assert [s for _, s in _steps(reports["port"])] == ["PASS"] * 7 and reports["port"].ok
    assert [n for n, _ in _steps(reports["port"])] == [
        "e2e_tree", "e2e_scan", "e2e_text_search", "e2e_image_self_retrieval",
        "e2e_duplicate_filter", "e2e_gallery", "e2e_check"]


def test_e2e_honors_source_like_tpuclip(hf_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("TPUCLIP_HOME", str(tmp_path / "home"))
    details = {}
    for name, mod in PACKAGES.items():
        extra = {"device": "cpu"} if name == "port" else {}
        report = mod.run_e2e_selftest(MODEL_NAME, str(tmp_path / "empty_cache"),
                                      work_dir=str(tmp_path / f"work_{name}"), source=str(hf_dir), **extra)
        assert report.ok, report.steps
        details[name] = next(s.detail for s in report.steps if s.name == "e2e_scan")
    assert details["port"] == details["tpuclip"] == "20 images indexed (checkpoint)"


def test_cli_exit_codes_like_tpuclip(hf_dir, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("TPUCLIP_HOME", str(tmp_path / "home"))
    for name, cli in (("port", pt_cli), ("tpuclip", jx_cli)):
        dev = ["--device", "cpu"] if name == "port" else []
        cli.main(["selftest", "--real-checkpoint", "--model", MODEL_NAME, "--source", str(hf_dir),
                  "--model-cache", str(tmp_path / "cache"), "--no-download",
                  "--convert-to", str(tmp_path / f"conv_{name}"), "--skip-parity", *dev])
        with pytest.raises(SystemExit) as exc:
            cli.main(["selftest", "--model", MODEL_NAME, "--model-cache", str(tmp_path / "emptycache"),
                      "--no-download", *dev])
        assert exc.value.code == 1
        with pytest.raises(SystemExit) as exc:  # a parity bound no model can meet
            cli.main(["selftest", "--model", MODEL_NAME, "--source", str(hf_dir), "--no-download",
                      "--model-cache", str(tmp_path / "cache"), "--convert-to", str(tmp_path / f"c2_{name}"),
                      "--parity-bound", "1.5", *dev])
        assert exc.value.code == 1


def test_strip_edge_specials_equals_tpuclip():
    specials = {0, 1, 2}
    for ids in ([2, 5, 6, 1, 0], [5, 1, 6], [1, 1], [], [0, 0, 3, 0]):
        assert pt_selftest._strip_edge_specials(ids, specials) == jx_selftest._strip_edge_specials(ids, specials)
    np.testing.assert_array_equal(pt_selftest._deterministic_pixels(56), jx_selftest._deterministic_pixels(56))
