"""Parity of the port's int8 search ops (tpuclip_torch/ops/topk_int8.py)
with tpuclip's, on the CPU: the JAX side runs its Pallas kernels in
interpret mode, the port its plain PyTorch versions. Inputs come from numpy
seeds and reach both frameworks as the same numpy arrays. The CUDA kernels
are compared with the plain versions on the card (skipped without one)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from test_torch_int8_topk import adversarial_index
from tpuclip.ops import topk_int8 as jx
from tpuclip_torch.ops import topk_int8 as pt

D = 128
N_VALID = 5000
N_PAD = 6144  # a multiple of the JAX test tile (1024) and of the port's (2048)


def _unit_rows(rng, n, d=D):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _bf16_values(x):
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


@pytest.fixture(scope="module")
def index():
    """(rows as bf16-exact fp32 values, port int8 matrix + scales, JAX
    transposed matrix + scales)."""
    rows = _bf16_values(_unit_rows(np.random.default_rng(0), N_VALID))
    m, scales = pt.derive_int8_matrix(torch.from_numpy(rows).to(torch.bfloat16), N_PAD)
    mt_j, scales_j = jx.derive_int8_matrix_device(jnp.asarray(rows, jnp.bfloat16), N_PAD)
    return rows, m, scales, np.asarray(mt_j), np.asarray(scales_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_derive_int8_matrix_bit_equal(dtype):
    rows = _unit_rows(np.random.default_rng(1), 700)
    if dtype == "bfloat16":
        rows = _bf16_values(rows)
    rows[5] = 0.0  # all-zero row: unit scale
    m, scales = pt.derive_int8_matrix(torch.from_numpy(rows).to(getattr(torch, dtype)), 1024)
    mt_j, scales_j = jx.derive_int8_matrix_device(jnp.asarray(rows, getattr(jnp, dtype)), 1024)
    np.testing.assert_array_equal(m.numpy().T, np.asarray(mt_j))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(scales_j))


def test_quantize_queries_bit_equal():
    q = _unit_rows(np.random.default_rng(2), 9)
    q[3] = 0.0
    qi, qs = pt.quantize_queries(torch.from_numpy(q))
    # jitted, as inside tpuclip's fused search program
    qi_j, qs_j = jax.jit(jx.quantize_queries_device)(jnp.asarray(q))
    np.testing.assert_array_equal(qi.numpy(), np.asarray(qi_j))
    np.testing.assert_array_equal(qs.numpy(), np.asarray(qs_j))


def test_round_f32_to_bf16_bits():
    rng = np.random.default_rng(5)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32),
        rng.standard_normal(256).astype(np.float32) * 1e-20,
        rng.standard_normal(256).astype(np.float32) * 1e20,
        np.asarray([0.0, -0.0, 1.0, -1.0, 1.00390625, 1.01171875, -1.00390625], np.float32),
    ])
    got = pt.round_f32_to_bf16_bits(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), torch.from_numpy(x).to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jx.round_f32_to_bf16_bits(jnp.asarray(x))))


@pytest.mark.parametrize("q_count", [1, 5])
def test_int8_scores_bit_equal_to_pallas(index, q_count):
    _, m, scales, mt_j, scales_j = index
    qi, _ = pt.quantize_queries(torch.from_numpy(_unit_rows(np.random.default_rng(3), q_count)))
    got = pt.int8_scores(qi, m, scales, N_VALID)
    want = jx.int8_scores_pallas(
        jnp.asarray(qi.numpy()), jnp.asarray(mt_j), jnp.asarray(scales_j),
        jnp.asarray(N_VALID, jnp.int32), tile_n=1024, interpret=True,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isneginf(got.numpy()[:, N_VALID:]).all()


@pytest.mark.parametrize("k_tile", [20, 128])
def test_int8_candidates_packed_bit_equal_to_pallas(index, k_tile):
    _, m, scales, mt_j, scales_j = index
    q_count = 3
    qi, _ = pt.quantize_queries(torch.from_numpy(_unit_rows(np.random.default_rng(4), q_count)))
    got = pt.int8_candidates_packed(qi, m, scales, k_tile, N_VALID, 1024).numpy()
    want = np.asarray(jx._int8_candidates_packed(
        jnp.asarray(qi.numpy()), jnp.asarray(mt_j), jnp.asarray(scales_j), k_tile,
        jnp.asarray(N_VALID, jnp.int32), 1024, True,
    ))[:q_count]
    np.testing.assert_array_equal(got, want)
    # Decoded per-tile candidates: the top-k_tile rows of each tile's scores.
    k_pad = -(-k_tile // 128) * 128
    u = got.view(np.uint32) ^ np.uint32(0x80000000)
    rows = (np.arange(got.shape[1]) // k_pad * 1024)[None] + (8191 - (u & 8191)).astype(np.int64)
    scores = pt.int8_scores(qi, m, scales, N_VALID).numpy()
    tile0 = np.argsort(-scores[0, :1024], kind="stable")[:k_tile]
    assert set(rows[0, :k_tile]) == set(tile0)


@pytest.mark.parametrize("q_count", [1, 4, 16])
@pytest.mark.parametrize("k", [1, 20])
def test_fused_auto_matches_jax_fused(index, q_count, k):
    rows, m, scales, mt_j, scales_j = index
    q = _unit_rows(np.random.default_rng(10 + q_count), q_count)
    rows_t = torch.from_numpy(rows).to(torch.bfloat16)
    s, i = pt.topk_int8_rerank_fused_auto(torch.from_numpy(q), m, scales, rows_t, k, n_valid=N_VALID)
    s_j, i_j = jx.topk_int8_rerank_fused(
        jnp.asarray(q), jnp.asarray(mt_j), jnp.asarray(scales_j),
        jnp.asarray(rows, jnp.bfloat16), k, n_valid=jnp.asarray(N_VALID, jnp.int32),
        tile_n=1024, use_pallas=True, interpret=True,
    )
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("method", ["exact", "extract"])
def test_planted_duplicates_lowest_row_first(index, method, monkeypatch):
    rows, *_ = index
    rows = rows.copy()
    planted = [4000, 17, 2500]
    target = rows[planted[0]].copy()
    for r in planted:
        rows[r] = target
    m, scales = pt.derive_int8_matrix(torch.from_numpy(rows).to(torch.bfloat16), N_PAD)
    monkeypatch.setenv("TPUCLIP_SHORTLIST", method)
    q = np.stack([target, _unit_rows(np.random.default_rng(7), 1)[0]])
    s, i = pt.topk_int8_rerank_fused_auto(
        torch.from_numpy(q), m, scales, torch.from_numpy(rows).to(torch.bfloat16), 5,
        n_valid=N_VALID,
    )
    assert i[0, :3].tolist() == sorted(planted)
    assert s[0, 0] == s[0, 1] == s[0, 2]


def test_shortlist_policy(monkeypatch):
    """``auto`` keeps exact / extract; every method named resolves to
    itself at any Q; an unknown name is refused."""
    monkeypatch.delenv("TPUCLIP_SHORTLIST", raising=False)
    assert pt.resolve_shortlist_method(1) == "exact"
    assert pt.resolve_shortlist_method(16) == "extract"
    monkeypatch.setenv("TPUCLIP_SHORTLIST", "auto")
    assert (pt.resolve_shortlist_method(1), pt.resolve_shortlist_method(64)) == ("exact", "extract")
    for method in ("approx", "verified", "exact", "extract"):
        monkeypatch.setenv("TPUCLIP_SHORTLIST", method)
        assert pt.resolve_shortlist_method(1) == pt.resolve_shortlist_method(16) == method
    monkeypatch.setenv("TPUCLIP_SHORTLIST", "fastest")
    with pytest.raises(ValueError, match="TPUCLIP_SHORTLIST"):
        pt.resolve_shortlist_method(1)


def test_cpu_tensors_take_the_plain_versions(index, monkeypatch):
    from tpuclip_torch.ops import _build

    _, m, scales, *_ = index
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("CPU call reached the CUDA library"))
    before = pt.int8_scores.launches, pt.int8_candidates_packed.launches
    qi = torch.zeros((2, D), dtype=torch.int8)
    pt.int8_scores(qi, m, scales, N_VALID)
    pt.int8_candidates_packed(qi, m, scales, 8, N_VALID, 1024)
    assert (pt.int8_scores.launches, pt.int8_candidates_packed.launches) == before


@pytest.mark.parametrize("bad", ["float_queries", "dim_mismatch", "n_valid", "tile"])
def test_wrappers_reject_bad_arguments(index, bad):
    _, m, scales, *_ = index
    qi = torch.zeros((2, D), dtype=torch.int8)
    if bad == "float_queries":
        with pytest.raises(TypeError):
            pt.int8_scores(qi.float(), m, scales, N_VALID)
    elif bad == "dim_mismatch":
        with pytest.raises(ValueError):
            pt.int8_scores(qi[:, :64].contiguous(), m, scales, N_VALID)
    elif bad == "n_valid":
        with pytest.raises(ValueError):
            pt.int8_scores(qi, m, scales, N_PAD + 1)
    else:
        with pytest.raises(ValueError):
            pt.int8_candidates_packed(qi, m, scales, 8, N_VALID, 1000)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the int8 scan kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("q_count", [1, 16, 64])
def test_cuda_kernels_match_plain(cuda_device, index, q_count):
    _, m, scales, *_ = index
    m, scales = m.to(cuda_device), scales.to(cuda_device)
    qi, _ = pt.quantize_queries(
        torch.from_numpy(_unit_rows(np.random.default_rng(8), q_count)).to(cuda_device)
    )
    torch.testing.assert_close(
        pt.int8_scores(qi, m, scales, N_VALID),
        pt._int8_scores_plain(qi, m, scales, N_VALID), rtol=0, atol=0,
    )
    torch.testing.assert_close(
        pt.int8_candidates_packed(qi, m, scales, 80, N_VALID, pt.PACKED_TILE_N),
        pt._int8_candidates_packed_plain(qi, m, scales, 80, N_VALID, pt.PACKED_TILE_N),
        rtol=0, atol=0,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("k_tile", [1, 80, 128, 300])
@pytest.mark.parametrize("q_count", [1, 3, 8, 16, 64])
def test_cuda_packed_select_on_adversarial_tiles(cuda_device, q_count, k_tile):
    """Kernel 2's threshold select bit for bit against its plain version on
    ``adversarial_index``'s tiles of equal, near-equal and -inf scores,
    through both selection teams (the block per query, a warp per query),
    both block sizes (8 and 16 queries) and the rank-count order above 128
    slots."""
    m, scales, n_valid, queries = adversarial_index()
    m, scales, qi = m.to(cuda_device), scales.to(cuda_device), queries[:q_count].to(cuda_device)
    args = (qi, m, scales, k_tile, n_valid, pt.PACKED_TILE_N)
    assert torch.equal(pt.int8_candidates_packed(*args), pt._int8_candidates_packed_plain(*args))


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_path(cuda_device, index, monkeypatch):
    from tpuclip_torch.ops import _build

    _, m, scales, *_ = index
    m, scales = m.to(cuda_device), scales.to(cuda_device)
    qi = torch.zeros((1, D), dtype=torch.int8, device=cuda_device)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(RuntimeError("no nvcc")))
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "missing")
    with pytest.raises(RuntimeError, match="no nvcc"):
        pt.int8_scores(qi, m, scales, N_VALID)
