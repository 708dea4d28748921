"""The port imports neither jax nor the JAX package (tpuclip), and the
pieces it carries as copies (configs, checkpoint reading, hamming helpers,
duplicate filter) equal tpuclip's originals on the same inputs; the
framework-neutral modules copied whole are held in
``tests/test_torch_copies.py``."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import tpuclip.index.dedup as jx_dedup
import tpuclip.ops.hamming as jx_hamming
from tpuclip.models import configs as jx_configs
from tpuclip.models.checkpoint import save_checkpoint, write_safetensors
from tpuclip.models.convert import params_from_state_dict as jx_params_from_state_dict
from tpuclip.models.convert import read_safetensors as jx_read_safetensors
from tpuclip.models.siglip import init_params
from tpuclip_torch.index import dedup as pt_dedup
from tpuclip_torch.models import configs as pt_configs
from tpuclip_torch.models.checkpoint import load_checkpoint
from tpuclip_torch.models.convert import params_from_state_dict, read_safetensors
from tpuclip_torch.ops import hamming as pt_hamming

REPO = Path(__file__).resolve().parents[1]


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _tree_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import tpuclip_torch, tpuclip_torch.engine, tpuclip_torch.cli\n"
        "import tpuclip_torch.index.search, tpuclip_torch.pipelines.scan\n"
        "import tpuclip_torch.pipelines.search, tpuclip_torch.models.loader\n"
        "import tpuclip_torch.ops._build\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_port_sources_never_import_jax():
    for path in (REPO / "tpuclip_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path


def test_port_imports_neither_tpuclip_nor_jax():
    """Every module of the port, and chip_smoke.py with what it imports,
    loaded in a fresh process: no ``tpuclip`` / ``tpuclip.*`` and no jax in
    ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpuclip_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(tpuclip_torch.__path__, 'tpuclip_torch.')]\n"
        "assert len(names) > 30, names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'tpuclip' or m.startswith('tpuclip.')\n"
        "             or m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


_TPUCLIP_IMPORT = re.compile(r"^\s*(?:from|import)\s+tpuclip(?:\.|\s|$)", re.MULTILINE)


def test_port_sources_never_import_tpuclip():
    paths = [*(REPO / "tpuclip_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    assert len(paths) > 30
    for path in paths:
        assert not _TPUCLIP_IMPORT.search(path.read_text()), path
    # The pattern does catch the forms it is for, and not the port's own name.
    assert _TPUCLIP_IMPORT.search("import tpuclip\n") and _TPUCLIP_IMPORT.search(
        "    from tpuclip.index.store import MetadataStore\n")
    assert not _TPUCLIP_IMPORT.search("from tpuclip_torch.index.store import MetadataStore\n")


def test_configs_copy_equals_original():
    assert pt_configs.DEFAULT_MODEL == jx_configs.DEFAULT_MODEL
    assert set(pt_configs.PRESETS) == set(jx_configs.PRESETS)
    for name, cfg in jx_configs.PRESETS.items():
        assert dataclasses.asdict(pt_configs.get_config(name)) == dataclasses.asdict(cfg)
        assert pt_configs.get_config(name).embedding_dim == cfg.embedding_dim
        assert pt_configs.get_config(name).vision.num_patches == cfg.vision.num_patches
    hf = {
        "model_type": "siglip",
        "vision_config": {"hidden_size": 96, "num_hidden_layers": 3, "patch_size": 14},
        "text_config": {"vocab_size": 999, "projection_size": 48},
    }
    for cfg in (hf, {**hf, "model_type": "siglip2"}):
        assert dataclasses.asdict(pt_configs.config_from_hf_dict("x", cfg)) == dataclasses.asdict(
            jx_configs.config_from_hf_dict("x", cfg)
        )


@pytest.mark.parametrize("fn", ["pack_bits", "sign_bits", "pack_bits_to_words", "hamming_distance_packed"])
def test_hamming_helpers_equal_original(fn):
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((17, 1152)).astype(np.float32)
    bits = (emb >= 0).astype(np.uint8)
    if fn == "sign_bits":
        args = (emb,)
    elif fn == "hamming_distance_packed":
        packed = np.packbits(bits, axis=-1)
        args = (packed, packed[::-1])
    else:
        args = (bits,)
    np.testing.assert_array_equal(getattr(pt_hamming, fn)(*args), getattr(jx_hamming, fn)(*args))


class _Store:
    def __init__(self, binaries):
        self.binaries = binaries

    def fetch_binary_for_paths(self, paths):
        return {p: self.binaries[p] for p in paths if p in self.binaries}


def test_dedup_copy_equals_original():
    rng = np.random.default_rng(1)
    base = (rng.standard_normal((6, 64)) >= 0).astype(np.uint8)
    bits = np.concatenate([base, base[:3]])  # three exact duplicates
    bits[7, :2] ^= 1  # within the 2-bit tolerance
    bits[8, :3] ^= 1  # beyond it
    binaries = {f"/p/{i}.jpg": bits[i] for i in range(9)}
    results = [(f"/p/{i}.jpg", float(s)) for i, s in enumerate(rng.random(9))]
    results.append(("/p/no_binary.jpg", 0.5))
    store = _Store(binaries)
    assert pt_dedup.filter_duplicates(store, results) == jx_dedup.filter_duplicates(store, results)
    lists = [results, results[::-1], []]
    assert pt_dedup.filter_duplicates_many(store, lists) == jx_dedup.filter_duplicates_many(store, lists)


def test_read_safetensors_equals_original(tmp_path):
    rng = np.random.default_rng(2)
    tensors = {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "bf16": rng.standard_normal((4, 2)).astype(ml_dtypes.bfloat16),
        "i8": rng.integers(-128, 127, (7,), dtype=np.int8),
        "scalar": np.asarray(1.5, np.float32),
    }
    path = str(tmp_path / "t.safetensors")
    write_safetensors(path, tensors)
    got, want = read_safetensors(path), jx_read_safetensors(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], np.asarray(want[k]).astype(got[k].dtype))
    assert got["bf16"].dtype == np.float32


def test_tpuclip_checkpoint_loads_in_port(tmp_path):
    cfg = jx_configs.get_config("tpuclip/test-tiny")
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(1), cfg))
    save_checkpoint(str(tmp_path / "ckpt"), params, cfg)
    pt_cfg, pt_params = load_checkpoint(str(tmp_path / "ckpt"))
    assert dataclasses.asdict(pt_cfg) == dataclasses.asdict(cfg)
    _tree_equal(pt_params, params)


def test_port_checkpoint_loads_in_tpuclip(tmp_path):
    """A checkpoint written by the port's ``save_checkpoint`` loads in
    tpuclip with equal parameters, and its files equal tpuclip's own."""
    from tpuclip.models.checkpoint import load_checkpoint as jx_load_checkpoint
    from tpuclip_torch.models.checkpoint import save_checkpoint as pt_save_checkpoint

    cfg = jx_configs.get_config("tpuclip/test-tiny")
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(2), cfg))
    pt_save_checkpoint(str(tmp_path / "port"), params, pt_configs.get_config("tpuclip/test-tiny"))
    save_checkpoint(str(tmp_path / "tpuclip"), params, cfg)
    got_cfg, got = jx_load_checkpoint(str(tmp_path / "port"))
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(cfg)
    _tree_equal(got, params)
    for name in ("tpuclip.json", "model.safetensors"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "tpuclip" / name).read_bytes()


def test_params_from_state_dict_equals_original():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.SiglipConfig(
        text_config=dict(vocab_size=64, hidden_size=32, intermediate_size=48,
                         num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=16),
        vision_config=dict(hidden_size=32, intermediate_size=48, num_hidden_layers=2,
                           num_attention_heads=4, image_size=28, patch_size=14),
    )
    torch.manual_seed(0)
    sd = {k: v.detach().float().numpy() for k, v in transformers.SiglipModel(hf_cfg).state_dict().items()}
    cfg = jx_configs.config_from_hf_dict("x", hf_cfg.to_dict())
    pt_cfg = pt_configs.config_from_hf_dict("x", hf_cfg.to_dict())
    _tree_equal(params_from_state_dict(sd, pt_cfg), jx_params_from_state_dict(sd, cfg))


def test_resolve_device():
    from tpuclip_torch.device import default_dtype, resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    assert default_dtype(torch.device("cpu")) == torch.float32
    with pytest.raises(ValueError):
        resolve_device("mps")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")


def test_random_init_is_seeded_and_scaled():
    from tpuclip_torch.models.loader import load_model

    cfg, a = load_model("tpuclip/test-tiny", None, device="cpu", allow_random=True, seed=4)
    _, b = load_model("tpuclip/test-tiny", None, device="cpu", allow_random=True, seed=4)
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    w = a.vision.encoder.layers[0].mlp.fc2.weight  # fan_in = intermediate_size
    assert abs(w.std().item() * np.sqrt(cfg.vision.intermediate_size) - 1.0) < 0.1
    assert torch.all(a.vision.encoder.layers[0].ln1.weight == 1)
    assert abs(a.text.token_embedding.weight.std().item() - 0.02) < 0.002


def test_serving_modules_import_neither_tpuclip_nor_jax():
    """The server, its UI and client, the classify pipeline, the CUDA graph
    runner, the CLI, selftest, the duplicate finder, the checkpoint writer
    and the CLI's copied pipelines, imported one by one in a fresh process,
    checked after each."""
    names = ("serve", "serve_ui", "client", "pipelines.classify", "ops.graphs", "cli", "selftest",
             "pipelines.duplicates", "models.checkpoint", "index.migrate", "pipelines.check",
             "pipelines.prune", "pipelines.export", "pipelines.merge")
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module('tpuclip_torch.' + name)\n"
        "    bad = sorted(m for m in sys.modules if m in ('tpuclip', 'jax')\n"
        "                 or m.startswith(('tpuclip.', 'jax.')))\n"
        "    assert not bad, (name, bad)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
