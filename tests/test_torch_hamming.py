"""Parity of the port's packed-binary search (tpuclip_torch/ops/hamming.py)
with tpuclip's, on the CPU: the JAX side runs its Pallas kernels in
interpret mode for k <= 128 and ``binary_topk_packed_t`` above, the port its
plain PyTorch versions. Inputs come from numpy seeds and reach both
frameworks as the same numpy words; tie-heavy inputs (few distinct rows,
many copies) hold the (matches desc, row asc) order. Kernels 5-7 are
compared with their plain versions on the card (skipped without one)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuclip.ops import hamming as jx
from tpuclip_torch.ops import hamming as pt

DIM = 64
N_VALID = 1000


def _words(bits):
    return jx.pack_bits_to_words(bits)  # (N, W) uint32


def _t(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


@pytest.fixture(scope="module", params=["random", "tie_heavy"])
def packed(request):
    rng = np.random.default_rng(7)
    if request.param == "random":
        bits = rng.integers(0, 2, (N_VALID, DIM), dtype=np.uint8)
    else:  # 6 distinct rows, each copied ~170 times in shuffled order
        bits = rng.integers(0, 2, (6, DIM), dtype=np.uint8)[rng.integers(0, 6, N_VALID)]
    words = _words(bits)
    queries = _words(rng.integers(0, 2, (5, DIM), dtype=np.uint8))
    wt, nv = jx.pad_words_t(words)
    padded, n_valid = pt.pad_words(_t(words))
    assert n_valid == nv == N_VALID
    return words, queries, jnp.asarray(wt), padded


def test_binary_scores_bit_equal_to_pallas(packed):
    _, queries, wt, padded = packed
    got = pt.binary_scores(_t(queries[:1]), padded, N_VALID).numpy()
    want = np.asarray(jx.binary_scores_pallas(
        jnp.asarray(queries[:1]), wt, n_valid=jnp.asarray(N_VALID, jnp.int32), interpret=True,
    ))
    np.testing.assert_array_equal(got[:, :N_VALID], want[:, :N_VALID])
    assert np.isneginf(got[:, N_VALID:]).all() and np.isneginf(want[:, N_VALID:]).all()


@pytest.mark.parametrize("k", [1, 20, 128, 300])
@pytest.mark.parametrize("q_count", [1, 4])
def test_binary_topk_matches_tpuclip(packed, q_count, k):
    _, queries, wt, padded = packed
    q = queries[:q_count]
    m, r = pt.binary_topk(_t(q), padded, k, N_VALID)
    nva = jnp.asarray(N_VALID, jnp.int32)
    if k <= 128:
        m_j, r_j = jx.binary_topk_packed_pallas(jnp.asarray(q), wt, k, n_valid=nva, interpret=True)
    else:
        m_j, r_j = jx.binary_topk_packed_t(jnp.asarray(q), wt, k, n_valid=nva)
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(r.numpy(), np.asarray(r_j))
    assert m.dtype == torch.int32 and r.dtype == torch.int64


def test_binary_topk_tie_order_and_padding(packed):
    """Rows of equal matches come lowest row first; with k past n_valid the
    padding rows follow in row order, scoring INT32_MIN."""
    words, queries, _, padded = packed
    m, r = pt.binary_topk(_t(queries[:2]), padded, padded.shape[0], N_VALID)
    for qi in range(2):
        mq, rq = m[qi].numpy(), r[qi].numpy()
        order = np.lexsort((rq, -np.maximum(mq.astype(np.int64), -1)))
        np.testing.assert_array_equal(order, np.arange(len(mq)))
        assert sorted(rq.tolist()) == list(range(padded.shape[0]))
        assert (mq[:N_VALID] >= 0).all() and (mq[N_VALID:] == -(2**31)).all()
        anded = np.ascontiguousarray(words & queries[qi]).view(np.uint8)
        np.testing.assert_array_equal(mq[:N_VALID], np.unpackbits(anded, axis=1).sum(1)[rq[:N_VALID]])


@pytest.mark.parametrize("m", [50, 400])
def test_binary_shortlist_q1_matches_tpuclip(packed, m):
    _, queries, wt, padded = packed
    s, i = pt.binary_shortlist_q1(_t(queries[:1]), padded, m, N_VALID)
    s_j, i_j = jx.binary_shortlist_q1(
        jnp.asarray(queries[:1]), wt, m, n_valid=jnp.asarray(N_VALID, jnp.int32), interpret=True,
    )
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))


def test_binary_shortlist_q1_m_exceeds_valid_rows(packed):
    _, queries, _, padded = packed
    s, i = pt.binary_shortlist_q1(_t(queries[:1]), padded, 64, 20)
    assert np.isfinite(s[0, :20].numpy()).all() and np.isneginf(s[0, 20:].numpy()).all()
    assert sorted(i[0, :20].tolist()) == list(range(20))


def test_merge_int_candidates_never_negates_the_sentinel():
    scores = torch.tensor([[-(2**31), 3, 0, 3, -(2**31)]], dtype=torch.int32)
    idx = torch.tensor([[0, 9, 4, 2, 1]])
    m, r = pt._merge_int_candidates(scores, idx, 5)
    assert r.tolist() == [[2, 9, 4, 0, 1]]
    assert m.tolist() == [[3, 3, 0, -(2**31), -(2**31)]]


def test_uint32_words_and_pad_words():
    rng = np.random.default_rng(2)
    words = _words(rng.integers(0, 2, (10, DIM), dtype=np.uint8))
    q = _words(rng.integers(0, 2, (1, DIM), dtype=np.uint8))
    as_u32 = pt.binary_topk(torch.from_numpy(q), torch.from_numpy(words), 4)
    as_i32 = pt.binary_topk(_t(q), _t(words), 4)
    assert torch.equal(as_u32[0], as_i32[0]) and torch.equal(as_u32[1], as_i32[1])
    padded, n = pt.pad_words(_t(words), tile_n=8)
    assert n == 10 and padded.shape == (16, 2) and not padded[10:].any()


def test_cpu_tensors_take_the_plain_versions(packed, monkeypatch):
    from tpuclip_torch.ops import _build

    _, queries, _, padded = packed
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("CPU call reached the CUDA library"))
    counters = (pt.binary_scores, pt.binary_topk_q1, pt.binary_topk_batched)
    before = [f.launches for f in counters]
    pt.binary_scores(_t(queries[:1]), padded, N_VALID)
    pt.binary_topk(_t(queries[:1]), padded, 5, N_VALID)
    pt.binary_topk(_t(queries[:3]), padded, 5, N_VALID)
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("bad", ["dtype", "width", "n_valid", "batch_scores"])
def test_wrappers_reject_bad_arguments(packed, bad):
    _, queries, _, padded = packed
    q = _t(queries[:2])
    if bad == "dtype":
        with pytest.raises(TypeError):
            pt.binary_topk(q.float(), padded.float(), 5)
    elif bad == "width":
        with pytest.raises(ValueError):
            pt.binary_topk(q[:, :1].contiguous(), padded, 5)
    elif bad == "n_valid":
        with pytest.raises(ValueError):
            pt.binary_topk(q, padded, 5, padded.shape[0] + 1)
    else:
        with pytest.raises(ValueError):
            pt.binary_scores(q, padded, N_VALID)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the binary scan kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("q_count", [1, 3, 16])
@pytest.mark.parametrize("k", [1, 20, 640, "all"])
def test_cuda_kernels_match_plain(cuda_device, packed, q_count, k):
    """Kernels 6 (Q = 1) and 7 (Q > 1) identical to the plain version at
    every k up to N; kernel 5 bit-equal."""
    _, queries, _, padded = packed
    rng = np.random.default_rng(q_count)
    q = _t(_words(rng.integers(0, 2, (q_count, DIM), dtype=np.uint8))).to(cuda_device)
    words = padded.to(cuda_device)
    k = words.shape[0] if k == "all" else k
    counter = pt.binary_topk_q1 if q_count == 1 else pt.binary_topk_batched
    before = counter.launches
    got = pt.binary_topk(q, words, k, N_VALID)
    assert counter.launches == before + 1
    want = pt._binary_topk_plain(q, words, k, N_VALID)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if q_count == 1:
        torch.testing.assert_close(
            pt.binary_scores(q, words, N_VALID), pt._binary_scores_plain(q, words, N_VALID),
            rtol=0, atol=0,
        )
