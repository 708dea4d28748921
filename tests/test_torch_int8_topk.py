"""The port's int8 search without the resident rows (tpuclip_torch/ops/
topk_int8.py) against tpuclip's, on the CPU: kernel 3's plain version
through ``topk_int8`` against tpuclip's ``topk_int8_pallas`` (its Pallas
kernel in interpret mode), the host query quantizer and the fp32 matrix
quantizer bit for bit, and the scores route against ``topk_int8_xla``.
Inputs come from numpy seeds and reach both frameworks as the same numpy
arrays. Kernel 3 is compared with its plain version on the card (skipped
without one)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuclip.ops import topk_int8 as jx
from tpuclip.ops.topk import pad_matrix_t
from tpuclip_torch.ops import topk_int8 as pt

D = 128
N_VALID = 5000  # not a multiple of either tile
N_PAD = 6144
PLANTED = [4000, 17, 2500]  # copies of one row: equal scores, lowest row first


def _unit_rows(rng, n, d=D):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def index():
    """(fp32 rows with planted copies, port int8 matrix + scales, tpuclip's
    transposed int8 matrix + scales, queries whose first is the planted row)."""
    rng = np.random.default_rng(0)
    rows = _unit_rows(rng, N_VALID)
    for r in PLANTED:
        rows[r] = rows[PLANTED[0]]
    m, scales = pt.quantize_matrix(rows, N_PAD, "cpu")
    mt, _ = pad_matrix_t(np.ascontiguousarray(rows.T), tile_n=N_PAD)
    mt_j, scales_j = jx.quantize_matrix_t(mt)
    queries = _unit_rows(rng, 33)
    queries[0] = rows[PLANTED[0]]
    return rows, m, scales, mt_j, scales_j, queries


def test_quantize_matrix_bit_equal_to_tpuclip():
    rows = _unit_rows(np.random.default_rng(1), 700) * np.float32(3.0)
    rows[5] = 0.0  # all-zero row: unit scale
    m, scales = pt.quantize_matrix(rows, 1024, "cpu")
    mt, _ = pad_matrix_t(np.ascontiguousarray(rows.T), tile_n=1024)
    mt_j, scales_j = jx.quantize_matrix_t(mt)
    np.testing.assert_array_equal(m.numpy().T, mt_j)
    np.testing.assert_array_equal(scales.numpy(), scales_j)
    # The resident-rows route quantizes the bf16 rows with x f32(1/127):
    # other scales and other int8 values.
    m_d, scales_d = pt.derive_int8_matrix(torch.from_numpy(rows).to(torch.bfloat16), 1024)
    assert not torch.equal(m_d, m) and not torch.equal(scales_d, scales)


def test_quantize_query_bit_equal_to_tpuclip():
    """2,000 queries of many magnitudes: the host form equals tpuclip's
    numpy ``quantize_query``; the jitted form (``quantize_queries``) differs
    on some, which is why one query outside the fused search takes the
    host form."""
    rng = np.random.default_rng(2)
    queries = rng.standard_normal((2000, D)).astype(np.float32)
    queries *= np.exp(rng.uniform(-8, 8, (2000, 1))).astype(np.float32)
    queries[7] = 0.0
    differ = 0
    for q in queries:
        qi, qs = pt.quantize_query(q)
        qi_j, qs_j = jx.quantize_query(q[None])
        np.testing.assert_array_equal(qi.numpy(), qi_j)
        assert qs == qs_j
        qi_d, qs_d = pt.quantize_queries(torch.from_numpy(q[None]))
        differ += float(qs_d) != np.float32(qs_j) or not np.array_equal(qi_d.numpy(), qi_j)
    assert pt.quantize_query(queries[7])[1] == 1.0
    assert differ > 0


@pytest.mark.parametrize("k", [1, 20, 128])
@pytest.mark.parametrize("q_count", [1, 3, 33])
def test_topk_int8_matches_pallas(index, q_count, k):
    """Kernel 3's plain version + merge against tpuclip's Pallas kernel
    (tile 1024 there, 2048 here: the exact top-k does not depend on it)."""
    _, m, scales, mt_j, scales_j, queries = index
    q = queries[:q_count]
    qi, qs = pt.quantize_query(q[0])
    qi = pt.quantize_queries(torch.from_numpy(q))[0] if q_count > 1 else qi
    s, i = pt.topk_int8(qi, m, scales, qs, k, N_VALID)
    s_j, i_j = jx.topk_int8_pallas(
        jnp.asarray(qi.numpy()), jnp.asarray(mt_j), jnp.asarray(scales_j),
        jnp.asarray(qs, jnp.float32), k, n_valid=jnp.asarray(N_VALID, jnp.int32),
        tile_n=1024, interpret=True,
    )
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    if k >= 3:
        assert i[0, :3].tolist() == sorted(PLANTED)
        assert s[0, 0] == s[0, 1] == s[0, 2]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [20, 300])
def test_topk_int8_scores_matches_xla(index, k, masked):
    """The scores route (kernel 1, mask, exact top-k, x q_scale) against
    ``topk_int8_xla``, and batched against ``topk_int8_batch``."""
    _, m, scales, mt_j, scales_j, queries = index
    mask = np.where(np.arange(N_PAD) % 3 == 0, 0.0, -np.inf).astype(np.float32) if masked else None
    mask_t = None if mask is None else torch.from_numpy(mask)
    mask_j = None if mask is None else jnp.asarray(mask)
    qi, qs = pt.quantize_query(queries[1])
    s, i = pt.topk_int8_scores(qi, m, scales, qs, k, N_VALID, mask_t)
    s_j, i_j = jx.topk_int8_xla(
        jnp.asarray(qi.numpy()), jnp.asarray(mt_j), jnp.asarray(scales_j),
        jnp.asarray(qs, jnp.float32), k, n_valid=jnp.asarray(N_VALID, jnp.int32), mask=mask_j,
    )
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    qb = torch.from_numpy(queries[:4])
    qi_b, qs_b = pt.quantize_queries(qb)
    s, i = pt.topk_int8_scores(qi_b, m, scales, qs_b, k, N_VALID, mask_t)
    s_j, i_j = jx.topk_int8_batch(
        jnp.asarray(queries[:4]), jnp.asarray(mt_j), jnp.asarray(scales_j), k,
        n_valid=jnp.asarray(N_VALID, jnp.int32), mask=mask_j,
    )
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))


def test_int8_candidates_contract(index):
    """Per tile: the top k_tile (score desc, row asc), then (-inf, INT32_MAX)
    up to k_pad; rows past n_valid score -inf."""
    _, m, scales, *_, queries = index
    qi, _ = pt.quantize_queries(torch.from_numpy(queries[:2]))
    s, i = pt.int8_candidates(qi, m, scales, 20, N_VALID, 2048)
    assert s.shape == i.shape == (2, 3 * 128)
    full = pt.int8_scores(qi, m, scales, N_VALID)
    for t in range(3):
        cs, ci = s[:, t * 128 : t * 128 + 20], i[:, t * 128 : t * 128 + 20].long()
        assert torch.equal(full.gather(1, ci), cs)
        assert bool(((ci >= t * 2048) & (ci < (t + 1) * 2048)).all())
        assert bool(((cs[:, :-1] > cs[:, 1:]) | ((cs[:, :-1] == cs[:, 1:]) & (ci[:, :-1] < ci[:, 1:]))).all())
        assert bool(torch.isneginf(s[:, t * 128 + 20 : (t + 1) * 128]).all())
        assert bool((i[:, t * 128 + 20 : (t + 1) * 128] == 2**31 - 1).all())
    # Tile 2 holds rows 4096..6143, of which 4096..4999 are valid.
    assert bool(torch.isfinite(s[:, 256:276]).all())


def test_cpu_tensors_take_the_plain_version(index, monkeypatch):
    from tpuclip_torch.ops import _build

    _, m, scales, *_ = index
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("CPU call reached the CUDA library"))
    before = pt.int8_candidates.launches
    pt.int8_candidates(torch.zeros((2, D), dtype=torch.int8), m, scales, 8, N_VALID, 2048)
    assert pt.int8_candidates.launches == before


@pytest.mark.parametrize("bad", ["tile", "k_tile", "float_queries"])
def test_int8_candidates_rejects_bad_arguments(index, bad):
    _, m, scales, *_ = index
    qi = torch.zeros((2, D), dtype=torch.int8)
    with pytest.raises((ValueError, TypeError)):
        if bad == "tile":
            pt.int8_candidates(qi, m, scales, 8, N_VALID, 1000)
        elif bad == "k_tile":
            pt.int8_candidates(qi, m, scales, 2049, N_VALID, 2048)
        else:
            pt.int8_candidates(qi.float(), m, scales, 8, N_VALID, 2048)


def lane_exhausting_matrix():
    """(4096, D) int8 rows whose top 128 for an all-ones query lie in the
    second 2048-row tile at local positions 0 and 1 mod 32, 64 each, with
    ties: kernel 3's selection warp reads slot i in lane i mod 32, so lane 0
    runs out of untaken slots halfway through k_tile = 128 rounds."""
    m = torch.zeros((4096, D), dtype=torch.int8)
    planted = [2048 + 32 * j + r for r in (0, 1) for j in range(64)]
    for rank, row in enumerate(planted):
        m[row] = 100 - rank // 2
    return m, torch.ones(4096), torch.ones((1, D), dtype=torch.int8), sorted(planted)


def test_lane_exhausting_matrix_plain():
    m, scales, qi, planted = lane_exhausting_matrix()
    s, i = pt.int8_candidates(qi, m, scales, 128, 4096, 2048)
    assert sorted(i[0, 128:].tolist()) == planted
    assert s[0, 128] == s[0, 129] and i[0, 128] < i[0, 129]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel 3 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k_tile", [20, 80, 128])
@pytest.mark.parametrize("q_count", [1, 16])
def test_cuda_kernel_matches_plain(cuda_device, index, q_count, k_tile):
    _, m, scales, *_, queries = index
    m, scales = m.to(cuda_device), scales.to(cuda_device)
    qi, _ = pt.quantize_queries(torch.from_numpy(queries[:q_count]).to(cuda_device))
    got = pt.int8_candidates(qi, m, scales, k_tile, N_VALID, pt.PACKED_TILE_N)
    want = pt._int8_candidates_plain(qi, m, scales, k_tile, N_VALID, pt.PACKED_TILE_N)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def adversarial_index():
    """(8192, D) int8 rows, scales, n_valid and 64 int8 queries, in four
    2048-row tiles built to break a threshold select: tile 0 random, tile 1
    one row repeated at one scale (every score equal: ties to the lowest
    row), tile 2 one row at scales 1 + j * 2**-22 (scores sharing their top
    radix digits, some equal after rounding), tile 3 past n_valid (all
    -inf, still candidates)."""
    rng = np.random.default_rng(11)
    m = rng.integers(-127, 128, (4 * 2048, D), dtype=np.int8)
    m[2048:4096] = m[2048]
    m[4096:6144] = m[4096]
    scales = rng.uniform(0.5, 1.5, 4 * 2048).astype(np.float32)
    scales[2048:4096] = 0.75
    scales[4096:6144] = 1.0 + np.arange(2048, dtype=np.float32) * np.float32(2.0**-22)
    queries = rng.integers(-127, 128, (64, D), dtype=np.int8)
    return torch.from_numpy(m), torch.from_numpy(scales), 3 * 2048, torch.from_numpy(queries)


def test_adversarial_tiles_plain():
    """What the adversarial tiles hold, on the plain version: tile 1's
    k_tile winners are its first rows (all tied), tile 3's are -inf in row
    order, tile 2 has more than 128 scores sharing their top 16 bits."""
    m, scales, n_valid, queries = adversarial_index()
    s, i = pt.int8_candidates(queries[:2], m, scales, 128, n_valid, 2048)
    s, i = s.view(2, 4, 128), i.view(2, 4, 128)
    assert i[:, 1].tolist() == [list(range(2048, 2048 + 128))] * 2
    assert bool((s[:, 1] == s[:, 1, :1]).all())
    assert i[:, 3].tolist() == [list(range(6144, 6144 + 128))] * 2
    assert bool(torch.isneginf(s[:, 3]).all())
    top16 = pt._u32(pt.int8_scores(queries[:2], m, scales, n_valid)[:, 4096:6144]) >> 16
    assert int((top16 == top16[:, :1]).sum(1).min()) > 128


@pytest.mark.cuda
@pytest.mark.parametrize("k_tile", [1, 80, 128, 300])
@pytest.mark.parametrize("q_count", [1, 3, 8, 16, 64])
def test_cuda_select_on_adversarial_tiles(cuda_device, q_count, k_tile):
    """Kernel 3's threshold select bit for bit against its plain version on
    tiles of equal, near-equal and -inf scores, through both selection
    teams (the block per query, a warp per query), both block sizes (8 and
    16 queries) and the rank-count order above 128 slots."""
    m, scales, n_valid, queries = adversarial_index()
    m, scales, qi = m.to(cuda_device), scales.to(cuda_device), queries[:q_count].to(cuda_device)
    args = (qi, m, scales, k_tile, n_valid, pt.PACKED_TILE_N)
    got, want = pt.int8_candidates(*args), pt._int8_candidates_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_kernel_lane_out_of_slots(cuda_device):
    """k_tile = 128 with 64 of the top rows in each of two lanes' slots:
    every lane still joins the warp's shuffles, and the result is the plain
    one."""
    m, scales, qi, planted = lane_exhausting_matrix()
    m, scales, qi = m.to(cuda_device), scales.to(cuda_device), qi.to(cuda_device)
    got = pt.int8_candidates(qi, m, scales, 128, 4096, 2048)
    want = pt._int8_candidates_plain(qi, m, scales, 128, 4096, 2048)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert sorted(got[1][0, 128:].tolist()) == planted
