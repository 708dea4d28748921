"""Parity of the port's bf16-path top-k (tpuclip_torch/ops/topk.py) with
tpuclip's, on the CPU: the JAX side runs ``topk_pallas`` in interpret mode
for k <= 128 and ``topk_xla`` above, the port its plain PyTorch versions.
Inputs come from numpy seeds and reach both frameworks as the same numpy
arrays; the matrix holds planted duplicate rows and N is not a multiple of
the tile. Kernel 4 is compared with its plain version on the card (skipped
without one)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuclip.ops import topk as jx
from tpuclip_torch.ops import topk as pt

D = 64
N_VALID = 3000  # pads to 4096: two 2048-row tiles, the second partial
PLANTED = [2900, 17, 1500]  # copies of one row: equal scores, lowest row first


def _unit_rows(rng, n, d=D):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    rows = _unit_rows(rng, N_VALID)
    for r in PLANTED:
        rows[r] = rows[PLANTED[0]]
    queries = _unit_rows(rng, 16)
    queries[0] = rows[PLANTED[0]]
    return rows, queries


@pytest.mark.parametrize("k", [1, 20, 128, 200])
@pytest.mark.parametrize("q_count", [1, 3, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cosine_topk_matches_tpuclip(data, dtype, q_count, k):
    rows, queries = data
    q = queries[:q_count]
    matrix, n_valid = pt.pad_matrix(torch.from_numpy(rows).to(getattr(torch, dtype)))
    assert matrix.shape[0] % pt.DEFAULT_TILE_N == 0 and n_valid == N_VALID
    s, i = pt.cosine_topk(torch.from_numpy(q), matrix, k, n_valid=n_valid)

    mt, nv = jx.pad_matrix_t(np.ascontiguousarray(rows.T))
    mt = jnp.asarray(mt, getattr(jnp, dtype))
    if k <= 128:
        s_j, i_j = jx.topk_pallas(jnp.asarray(q), mt, k, n_valid=jnp.asarray(nv), interpret=True)
    else:
        s_j, i_j = jx.topk_xla(jnp.asarray(q), mt, k, n_valid=jnp.asarray(nv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    atol = 1e-6 if dtype == "float32" else 1e-5
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=0, atol=atol)
    if k >= 3:
        assert i[0, :3].tolist() == sorted(PLANTED)
        assert s[0, 0] == s[0, 1] == s[0, 2]


def test_bf16_rows_round_the_query(data):
    """Against bf16 rows the query is cast to bf16 before the dot, in kernel
    4's reference and in the k > 128 route (both sum in float64 on the
    CPU)."""
    rows, queries = data
    matrix, n_valid = pt.pad_matrix(torch.from_numpy(rows).to(torch.bfloat16))
    q = torch.from_numpy(queries[:2])
    want = (q.to(torch.bfloat16).double() @ matrix[:n_valid].double().T).float()
    unrounded = (q.double() @ matrix[:n_valid].double().T).float()
    assert (want - unrounded).abs().max() > 1e-4
    for route in (pt._topk_tiles_plain, pt.topk_plain):
        s, i = route(q, matrix, 5, n_valid)
        np.testing.assert_array_equal(s.numpy(), want.gather(1, i).numpy())


def test_pad_matrix_zero_rows():
    rows = torch.ones((5, 8))
    padded, n = pt.pad_matrix(rows, tile_n=4)
    assert n == 5 and padded.shape == (8, 8)
    assert torch.equal(padded[:5], rows) and not padded[5:].any()
    same, n = pt.pad_matrix(torch.ones((8, 8)), tile_n=4)
    assert n == 8 and same.shape == (8, 8)


def test_rows_past_n_valid_never_returned():
    rows = _unit_rows(np.random.default_rng(3), 40)
    matrix, _ = pt.pad_matrix(torch.from_numpy(rows), tile_n=64)
    q = torch.from_numpy(rows[30:31])  # the best row lies past n_valid
    for k in (10, 150):
        s, i = pt.cosine_topk(q, matrix, k, n_valid=25)
        finite = torch.isfinite(s[0])
        assert int(finite.sum()) == min(k, 25) and bool((i[0][finite] < 25).all())
        assert bool((i[0][~finite] == 2**31 - 1).all())


def test_final_merge_ties_and_order():
    scores = torch.tensor([[0.5, 0.9, 0.5, float("-inf"), 0.9, -0.0, 0.0]])
    idx = torch.tensor([[10, 7, 3, 1, 2, 9, 8]])
    s, i = pt._final_merge(scores, idx, 6)
    assert i.tolist() == [[2, 7, 3, 10, 8, 9]]
    assert torch.equal(s[0, :4], torch.tensor([0.9, 0.9, 0.5, 0.5]))


def test_cpu_tensors_take_the_plain_version(data, monkeypatch):
    from tpuclip_torch.ops import _build

    rows, queries = data
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("CPU call reached the CUDA library"))
    before = pt.topk_tiles.launches
    matrix, n_valid = pt.pad_matrix(torch.from_numpy(rows).to(torch.bfloat16))
    pt.topk_tiles(torch.from_numpy(queries[:2]), matrix, 20, n_valid)
    assert pt.topk_tiles.launches == before


@pytest.mark.parametrize("bad", ["int_queries", "dim_mismatch", "n_valid", "k"])
def test_topk_tiles_rejects_bad_arguments(data, bad):
    rows, queries = data
    matrix = torch.from_numpy(rows)
    q = torch.from_numpy(queries[:2])
    if bad == "int_queries":
        with pytest.raises(TypeError):
            pt.topk_tiles(q.to(torch.int32), matrix, 5)
    elif bad == "dim_mismatch":
        with pytest.raises(ValueError):
            pt.topk_tiles(q[:, :32].contiguous(), matrix, 5)
    elif bad == "n_valid":
        with pytest.raises(ValueError):
            pt.topk_tiles(q, matrix, 5, N_VALID + 1)
    else:
        with pytest.raises(ValueError):
            pt.topk_tiles(q, matrix, 129)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel 4 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("q_count", [1, 3, 16])
@pytest.mark.parametrize("k", [1, 20, 128])
def test_cuda_kernel_matches_plain(cuda_device, data, q_count, k):
    """Kernel 4 against its plain version on the same CUDA tensors: scores
    within 1e-5 (fp32 accumulation order), every returned row within 1e-5
    of the plain k-th score, ordered (score desc, row asc)."""
    rows, queries = data
    matrix, n_valid = pt.pad_matrix(torch.from_numpy(rows).to(torch.bfloat16).to(cuda_device))
    q = torch.from_numpy(queries[:q_count]).to(cuda_device)
    before = pt.topk_tiles.launches
    s, i = pt.topk_tiles(q, matrix, k, n_valid)
    assert pt.topk_tiles.launches == before + 1
    s_p, _ = pt._topk_tiles_plain(q, matrix, k, n_valid)
    torch.testing.assert_close(s, s_p, rtol=0, atol=1e-5)
    plain = pt._scores_plain(q, matrix, n_valid).gather(1, i)
    assert bool((plain >= s_p[:, -1:] - 1e-5).all())
    assert bool(((s[:, :-1] > s[:, 1:]) | ((s[:, :-1] == s[:, 1:]) & (i[:, :-1] < i[:, 1:]))).all())
    if k >= 3:
        assert i[0, :3].tolist() == sorted(PLANTED)


def lane_exhausting_rows(n_rows=2 * pt.DEFAULT_TILE_N, d=D, seed=5):
    """Rows whose top 128 for the returned query all lie in the second tile
    at local positions 0 and 1 mod 32 (64 each), the best 64 at 0: kernel
    4's warp reads slot i in lane i mod 32, so lane 0 runs out of untaken
    slots halfway through the k = 128 rounds. Everything else scores below
    0.1."""
    rng = np.random.default_rng(seed)
    q = _unit_rows(rng, 1, d)
    rows = 0.1 * _unit_rows(rng, n_rows, d)
    tile = pt.DEFAULT_TILE_N
    planted = [tile + 32 * j + r for r in (0, 1) for j in range(tile // 32)]
    for rank, row in enumerate(planted):
        rows[row] = (1.0 - rank / 200.0) * q[0]
    return rows, q, sorted(planted)


def test_lane_exhausting_rows_plain():
    """The plain version finds exactly the planted rows of the case below."""
    rows, q, planted = lane_exhausting_rows()
    matrix = torch.from_numpy(rows).to(torch.bfloat16)
    s, i = pt.topk_tiles(torch.from_numpy(q), matrix, 128, len(rows))
    assert sorted(i[0].tolist()) == planted and bool((s[0] > 0.3).all())


@pytest.mark.cuda
@pytest.mark.parametrize("q_count", [1, 16])
def test_cuda_topk_plain_route(cuda_device, data, q_count):
    """The k > 128 route on the card (an fp32 matmul) against kernel 4's
    float64 reference: scores within 1e-5, ordered (score desc, row asc)."""
    rows, queries = data
    matrix, n_valid = pt.pad_matrix(torch.from_numpy(rows).to(torch.bfloat16).to(cuda_device))
    q = torch.from_numpy(queries[:q_count]).to(cuda_device)
    s, i = pt.cosine_topk(q, matrix, 200, n_valid)
    s_p, _ = pt._topk_tiles_plain(q, matrix, 200, n_valid)
    torch.testing.assert_close(s, s_p, rtol=0, atol=1e-5)
    assert bool(((s[:, :-1] > s[:, 1:]) | ((s[:, :-1] == s[:, 1:]) & (i[:, :-1] < i[:, 1:]))).all())


@pytest.mark.cuda
def test_cuda_kernel_lane_out_of_slots(cuda_device):
    """k = 128 with 64 of the top rows in each of two lanes' slots: every
    lane still joins the warp's shuffles, and the result is the plain one."""
    rows, q, planted = lane_exhausting_rows()
    matrix = torch.from_numpy(rows).to(torch.bfloat16).to(cuda_device)
    q = torch.from_numpy(q).to(cuda_device)
    s, i = pt.topk_tiles(q, matrix, 128, len(rows))
    s_p, _ = pt._topk_tiles_plain(q, matrix, 128, len(rows))
    assert sorted(i[0].tolist()) == planted
    torch.testing.assert_close(s, s_p, rtol=0, atol=1e-5)
    assert bool(((s[:, :-1] > s[:, 1:]) | ((s[:, :-1] == s[:, 1:]) & (i[:, :-1] < i[:, 1:]))).all())


@pytest.fixture(scope="module")
def wide_rows():
    """Random unit rows, 3 tiles of them, at D = 1152 and at D = 784 (not a
    multiple of the kernel's 64-element K slice), and 64 unit queries."""
    rng = np.random.default_rng(11)
    n = 3 * pt.DEFAULT_TILE_N
    return {d: (_unit_rows(rng, n, d), _unit_rows(rng, 64, d)) for d in (1152, 784)}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1152, 784])
@pytest.mark.parametrize("k", [1, 20, 127, 128])
@pytest.mark.parametrize("q_count", [1, 7, 8, 9, 16, 17, 64])
def test_cuda_kernel_query_blocks(cuda_device, wide_rows, q_count, k, d):
    """Kernel 4 across its block plans: 1-8 queries (8 warps, the block or a
    warp per query selecting), 9-16 (two mma groups, 32 warps), and more
    than one block of queries per tile; n_valid mid-tile, with the rows past
    it non-zero, so that none of them may come back."""
    rows, queries = wide_rows[d]
    n_valid = 2 * pt.DEFAULT_TILE_N + 1000
    matrix = torch.from_numpy(rows).to(torch.bfloat16).to(cuda_device)
    q = torch.from_numpy(queries[:q_count]).to(cuda_device)
    before = pt.topk_tiles.launches
    s, i = pt.topk_tiles(q, matrix, k, n_valid)
    assert pt.topk_tiles.launches == before + 1
    s_p, _ = pt._topk_tiles_plain(q, matrix, k, n_valid)
    torch.testing.assert_close(s, s_p, rtol=0, atol=1e-5)
    assert bool((i < n_valid).all())
    plain = pt._scores_plain(q, matrix, n_valid).gather(1, i)
    assert bool((plain >= s_p[:, -1:] - 1e-5).all())
    assert bool(((s[:, :-1] > s[:, 1:]) | ((s[:, :-1] == s[:, 1:]) & (i[:, :-1] < i[:, 1:]))).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [20, 128])
@pytest.mark.parametrize("q_count", [1, 9])
def test_cuda_kernel_ragged_last_tile(cuda_device, wide_rows, q_count, k):
    """A matrix whose row count is not a multiple of the tile (5000 rows:
    the third tile holds 904): the kernel reads no row past the matrix and
    no slot of the last tile returns one."""
    rows, queries = wide_rows[1152]
    matrix = torch.from_numpy(rows[:5000]).to(torch.bfloat16).to(cuda_device)
    q = torch.from_numpy(queries[:q_count]).to(cuda_device)
    s, i = pt.topk_tiles(q, matrix, k)
    s_p, i_p = pt._topk_tiles_plain(q, matrix, k)
    torch.testing.assert_close(s, s_p, rtol=0, atol=1e-5)
    assert bool((i < 5000).all())
    assert bool(((s[:, :-1] > s[:, 1:]) | ((s[:, :-1] == s[:, 1:]) & (i[:, :-1] < i[:, 1:]))).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [20, 128])
@pytest.mark.parametrize("q_count", [1, 9])
def test_cuda_kernel_equal_and_signed_zero_scores(cuda_device, q_count, k):
    """Ties in a tile, against the exact expected rows: tile 0 holds 2048
    copies of one row (every score -0.25), tile 1 rows scoring below -0.5
    and 40 rows scoring exactly zero, half of them with a -0.0 first
    component. The top k is the zero rows in row order (-0.0 ranks as
    +0.0), then tile 0's rows in row order."""
    d, tile = 1152, pt.DEFAULT_TILE_N
    rng = np.random.default_rng(12)
    rows = np.zeros((2 * tile, d), np.float32)
    rows[:tile, 0] = -0.25
    rows[tile:, 0] = -rng.uniform(0.5, 1.0, tile)
    rows[tile:, 1:] = rng.standard_normal((tile, d - 1)) * 0.01
    zeros = [tile + 7 + 50 * j for j in range(40)]
    rows[zeros, 0] = [-0.0 if j % 2 else 0.0 for j in range(40)]
    queries = np.zeros((q_count, d), np.float32)
    queries[:, 0] = 1.0
    matrix = torch.from_numpy(rows).to(torch.bfloat16).to(cuda_device)
    q = torch.from_numpy(queries).to(cuda_device)
    s, i = pt.topk_tiles(q, matrix, k, len(rows))
    want = (zeros + list(range(tile)))[:k]
    assert i.tolist() == [want] * q_count
    assert bool((s[:, :40] == 0).all()) and bool((s[:, 40:] == -0.25).all())
    s_p, i_p = pt._topk_tiles_plain(q, matrix, k, len(rows))
    assert torch.equal(i, i_p) and bool((s == s_p).all())
