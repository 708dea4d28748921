"""The port's capacity gate for the flat matrix against tpuclip's, on the
CPU: on CUDA the port must answer as tpuclip does on the TPU (the gate
always on, 12 GB by default and for a malformed value), and on the CPU as
tpuclip off the TPU (only when ``TPUCLIP_INDEX_HBM_GB`` is set). The port's
index has its ``device`` set to CUDA after construction and tpuclip's sees
``jax.default_backend()`` return "tpu"; only the gate runs, so no card is
needed. Also: an index over the cap logs the same warning in both packages
and serves from its binary rows, and ``load_model`` with no device asks for
the card."""

import sqlite3

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuclip.index.search as jax_search
from tpuclip.index.store import MetadataStore
from tpuclip_torch.index.search import DeviceIndex as TorchIndex

DIM = 1152


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in ("TPUCLIP_INDEX_HBM_GB", "TPUCLIP_SEARCH_MODE", "TPUCLIP_SHARDED_INDEX",
                 "TPUCLIP_DEVICE_RERANK", "TPUCLIP_SEARCH_RERANK", "TPUCLIP_QUIET"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TPUCLIP_SEARCH_PRECISION", "int8")


def _store(tmp_path, dim=DIM):
    store = MetadataStore(str(tmp_path / "gate.db"), embedding_dim=dim)
    store.init_schema(verbose=False)
    return store


def _gates(tmp_path, monkeypatch, precision, accelerator):
    """(port's gate, tpuclip's gate) over one empty store: the port's index
    on CUDA and tpuclip's on the TPU when ``accelerator``, else both on the
    CPU."""
    monkeypatch.setenv("TPUCLIP_SEARCH_PRECISION", precision)
    store = _store(tmp_path)
    tx = TorchIndex(store, device="cpu", matrix_dtype=torch.bfloat16)
    jx = jax_search.DeviceIndex(store, matrix_dtype=jnp.bfloat16)
    if accelerator:
        tx.device = torch.device("cuda")
        monkeypatch.setattr(jax_search.jax, "default_backend", lambda: "tpu")
    return tx._flat_matrix_fits, jx._flat_matrix_fits


@pytest.mark.parametrize(
    "n_rows, precision, env, fits",
    [
        (11_000_000, "int8", None, False),  # 12.67 GB over the 12 GB default
        (10_000_000, "int8", None, True),  # 11.52 GB
        (11_000_000, "int8", "abc", False),  # malformed: the 12 GB default
        (10_000_000, "int8", "abc", True),
        (11_000_000, "int8", "20", True),
        (18_000_000, "int8", "20", False),
        (5_500_000, "bf16", None, False),  # 2 bytes a value: 12.67 GB
        (5_000_000, "bf16", None, True),
    ],
)
def test_gate_on_cuda_matches_tpuclip_on_the_tpu(tmp_path, monkeypatch, capsys, n_rows, precision, env, fits):
    if env is not None:
        monkeypatch.setenv("TPUCLIP_INDEX_HBM_GB", env)
    port, ref = _gates(tmp_path, monkeypatch, precision, accelerator=True)
    assert ref(n_rows) is fits
    assert port(n_rows) is fits
    out = capsys.readouterr().out
    if env == "abc":
        assert out.count("[WARNING] ignoring malformed TPUCLIP_INDEX_HBM_GB='abc'") == 2


@pytest.mark.parametrize("env, fits", [(None, True), ("abc", False), ("20", True), ("1", False)])
def test_gate_on_the_cpu_matches_tpuclip_off_the_tpu(tmp_path, monkeypatch, env, fits):
    """Off the accelerator the gate applies only when the variable is set;
    a malformed value then takes the 12 GB default."""
    if env is not None:
        monkeypatch.setenv("TPUCLIP_INDEX_HBM_GB", env)
    port, ref = _gates(tmp_path, monkeypatch, "int8", accelerator=False)
    assert jax.default_backend() != "tpu"
    assert ref(11_000_000) is fits
    assert port(11_000_000) is fits


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_over_the_cap_warns_and_serves_binary_rows_as_tpuclip(tmp_path, monkeypatch, capsys):
    """``refresh`` with a cap below a tiny store: no flat matrix, the same
    warning, and the binary rows' results, equal to tpuclip's."""
    dim = 64
    vecs = _unit(np.random.default_rng(3), 300, dim)
    store = _store(tmp_path, dim)
    conn = sqlite3.connect(store.db_path)
    batch = [(f"/img/{i:04d}.jpg", float(i), f"h{i}", vecs[i]) for i in range(len(vecs))]
    store.commit_with_retry(conn.cursor(), conn, batch, save_full_embeddings=True)
    conn.close()
    monkeypatch.setenv("TPUCLIP_INDEX_HBM_GB", "0.000001")
    queries = _unit(np.random.default_rng(4), 2, dim)
    capsys.readouterr()
    tx = TorchIndex(store, device="cpu")
    got = tx.search_batch(queries, 10)
    port_out = capsys.readouterr().out
    want = jax_search.DeviceIndex(store).search_batch(queries, 10)
    ref_out = capsys.readouterr().out
    assert tx._matrix is None and tx.num_binary == len(vecs)
    # tpuclip names the chip's HBM where the port names the device.
    for out in (port_out, ref_out):
        assert "[WARNING] index too large for " in out
        assert "(300 x 64 int8 exceeds TPUCLIP_INDEX_HBM_GB) — serving from the binary index" in out
    assert [[p for p, _ in r] for r in got] == [[p for p, _ in r] for r in want]
    assert all(s == int(s * dim) / dim for results in got for _, s in results)


def test_load_model_without_a_device_asks_for_the_card(monkeypatch):
    """``load_model()`` resolves no device to CUDA, which raises without a
    card; the CPU is used only when named."""
    from tpuclip_torch.models.loader import load_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        load_model("tpuclip/test-tiny", None, allow_random=True)
    cfg, model = load_model("tpuclip/test-tiny", None, device="cpu", allow_random=True)
    assert next(model.parameters()).device == torch.device("cpu")
