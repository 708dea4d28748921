"""Kernels 6 and 7 (``binary_topk_q1`` / ``binary_topk_batched``) on the
inputs that stress their threshold and collect: every row the same bits
(one bin holds every row), an all-zero query (every score 0), ``n_valid``
ending inside a chunk and a sub-tile, k = 1, k = N_pad and k ending exactly
at a bin boundary and one row past it, Q = 1 to 64 (one and two 8-query
mma tiles, full and partial groups of 16), W = 1 and W = 64, and a batch
split into query groups mid-batch by the scratch limit.

On the CPU the plain version is held against a numpy brute force (sort
by matches desc, row asc), and the scratch plan against its contract; the
``cuda``-marked cases hold each kernel identical to the plain version on
the card, its launch counter rising once per call (skipped without one).
"""

import numpy as np
import pytest
import torch

from tpuclip_torch.ops import hamming as pt

INT32_MIN = -(2**31)


def _words(rng, n, w, kind="random"):
    """(n, w) int32 packed words: random bits, every row the same bits, or
    rows drawn from 5 distinct rows (dense ties)."""
    if kind == "same":
        row = rng.integers(0, 2**32, (1, w), dtype=np.uint64)
        x = np.repeat(row, n, axis=0)
    elif kind == "few":
        x = rng.integers(0, 2**32, (5, w), dtype=np.uint64)[rng.integers(0, 5, n)]
    else:
        x = rng.integers(0, 2**32, (n, w), dtype=np.uint64)
    return torch.from_numpy(x.astype(np.uint32).view(np.int32))


def _reference(q, words, k, n_valid):
    """Brute force in numpy: (matches, rows), matches desc then row asc."""
    qb = q.numpy().view(np.uint8)
    wb = words.numpy().view(np.uint8)
    out_m, out_r = [], []
    for row in qb:
        m = np.unpackbits(wb & row[None, :], axis=1).sum(1).astype(np.int64)
        m[n_valid:] = -1
        order = np.lexsort((np.arange(len(m)), -m))[:k]
        out_m.append(np.where(m[order] < 0, INT32_MIN, m[order]).astype(np.int32))
        out_r.append(order.astype(np.int64))
    return np.stack(out_m), np.stack(out_r)


def _bin_edge(q, words, n_valid):
    """A k that ends exactly at a bin boundary for query 0: the number of
    valid rows scoring above its median score (at least 1)."""
    m = np.unpackbits(words.numpy()[:n_valid].view(np.uint8) & q.numpy()[0].view(np.uint8)[None],
                      axis=1).sum(1)
    return max(1, int((m > np.median(m)).sum()))


def _case(name, rng):
    """(queries, padded words, n_valid, ks) of one adversarial case, small
    enough for the CPU."""
    if name == "same_rows":
        words, n = pt.pad_words(_words(rng, 1000, 36, "same"))
        q = _words(rng, 3, 36)
        return q, words, n, [1, 20, 999, 1000, words.shape[0]]
    if name == "zero_query":
        words, n = pt.pad_words(_words(rng, 1000, 36))
        return torch.zeros((2, 36), dtype=torch.int32), words, n, [1, 640, words.shape[0]]
    if name == "n_valid_mid":
        words, _ = pt.pad_words(_words(rng, 1500, 36, "few"))
        return _words(rng, 4, 36), words, 1333, [1, 1333, 1334, words.shape[0]]
    if name == "w1":
        words, n = pt.pad_words(_words(rng, 700, 1))
        return _words(rng, 3, 1), words, n, [1, 30, words.shape[0]]
    if name == "w64":
        words, n = pt.pad_words(_words(rng, 700, 64))
        return _words(rng, 9, 64), words, n, [1, 30, words.shape[0]]
    raise ValueError(name)


CASES = ["same_rows", "zero_query", "n_valid_mid", "w1", "w64"]


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_brute_force(name):
    q, words, n_valid, ks = _case(name, np.random.default_rng(11))
    ks = ks + [_bin_edge(q, words, n_valid), _bin_edge(q, words, n_valid) + 1]
    for k in ks:
        m, r = pt.binary_topk(q, words, k, n_valid)
        want_m, want_r = _reference(q, words, k, n_valid)
        np.testing.assert_array_equal(m.numpy(), want_m, err_msg=f"{name} k={k}")
        np.testing.assert_array_equal(r.numpy(), want_r, err_msg=f"{name} k={k}")


@pytest.mark.parametrize("q_count", [1, 3, 8, 9, 16, 17, 64])
def test_plain_matches_brute_force_per_batch(q_count):
    rng = np.random.default_rng(q_count)
    words, n = pt.pad_words(_words(rng, 600, 8, "few"))
    q = _words(rng, q_count, 8)
    for k in (1, 20, _bin_edge(q, words, n)):
        m, r = pt.binary_topk(q, words, k, n)
        want_m, want_r = _reference(q, words, k, n)
        np.testing.assert_array_equal(m.numpy(), want_m)
        np.testing.assert_array_equal(r.numpy(), want_r)


# The scratch plan of kernels 6 and 7 (pure Python: it runs here).


@pytest.mark.parametrize("n", [1, 255, 256, 10_000_128, 100_000_000])
@pytest.mark.parametrize("sms", [1, 132])
def test_plan_chunks(n, sms):
    chunk_rows, group, n_bytes = pt._binary_plan(1, n, 36, sms)
    assert chunk_rows % pt.BINARY_TILE_N == 0 and pt.BINARY_TILE_N <= chunk_rows <= pt._MAX_CHUNK_ROWS
    n_chunks = -(-n // chunk_rows)
    # About _BLOCKS_PER_SM chunks per SM, unless the 16-bit counters cap a chunk.
    assert n_chunks <= pt._BLOCKS_PER_SM * sms or chunk_rows == pt._MAX_CHUNK_ROWS
    assert group == 1 and n_bytes == pt._scratch_bytes(1, n, 36, n_chunks)


def test_scratch_bytes_at_the_smoke_shape():
    """10,000,128 rows x 36 words in 528 chunks, per query: 1154 bins x 529
    int32 counts, 1154 totals and 4 ints, then 10,000,128 uint16 bins."""
    bins = 32 * 36 + 2
    per_query_ints = bins * 529 + bins + 4
    want = -(-64 * per_query_ints * 4 // 16) * 16 + 64 * 10_000_128 * 2
    assert pt._scratch_bytes(64, 10_000_128, 36, 528) == want
    chunk_rows, group, n_bytes = pt._binary_plan(64, 10_000_128, 36, 132)
    assert (chunk_rows, group, n_bytes) == (18944, 64, want)
    assert n_bytes < pt.SCRATCH_MAX_BYTES


@pytest.mark.parametrize("q_count", [9, 17, 64, 200])
@pytest.mark.parametrize("limit_queries", [0.5, 1.5, 5.5, 12.5, 40.5])
def test_plan_groups_fit_the_limit(monkeypatch, q_count, limit_queries):
    n, w, sms = 100_000, 36, 132
    one = pt._binary_plan(1, n, w, sms)[2]
    monkeypatch.setattr(pt, "SCRATCH_MAX_BYTES", int(one * limit_queries))
    _, group, n_bytes = pt._binary_plan(q_count, n, w, sms)
    fit = int(limit_queries)
    if q_count <= fit:
        assert group == q_count
    else:
        assert 1 <= group <= max(1, fit)
        assert group == max(1, fit - fit % 16 if fit >= 16 else fit)
        assert n_bytes <= pt.SCRATCH_MAX_BYTES or group == 1
    chunk_rows = pt._binary_plan(1, n, w, sms)[0]
    assert n_bytes == pt._scratch_bytes(group, n, w, -(-n // chunk_rows))


# On the card.


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the binary top-k kernels have no CPU mode")
    return torch.device("cuda")


def _check_kernel(q, words, k, n_valid):
    counter = pt.binary_topk_q1 if q.shape[0] == 1 else pt.binary_topk_batched
    before = counter.launches
    got = pt.binary_topk(q, words, k, n_valid)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = pt._binary_topk_plain(q, words, k, n_valid)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), f"k={k}"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_cuda_adversarial_cases(cuda_device, name):
    q, words, n_valid, ks = _case(name, np.random.default_rng(11))
    ks = ks + [_bin_edge(q, words, n_valid), _bin_edge(q, words, n_valid) + 1]
    q, words = q.to(cuda_device), words.to(cuda_device)
    for k in ks:
        for qs in (q[:1], q):
            _check_kernel(qs, words, k, n_valid)


@pytest.mark.cuda
@pytest.mark.parametrize("q_count", [1, 3, 8, 9, 16, 17, 64])
def test_cuda_batches(cuda_device, q_count):
    """400,000 random rows: chunks of several sub-tiles, scores in dense
    ties; k = 1, 20, 640 and at a bin boundary and one row past it."""
    rng = np.random.default_rng(100 + q_count)
    words, n = pt.pad_words(_words(rng, 400_000, 36))
    q = _words(rng, q_count, 36)
    m = pt._binary_topk_plain(q[:1], words, 641, n)[0][0]
    above = int((m > m[640]).sum())  # query 0's rows above the 641st row's bin
    ks = [1, 20, 640, max(1, above), above + 1]
    q, words = q.to(cuda_device), words.to(cuda_device)
    for k in ks:
        _check_kernel(q, words, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["same", "few"])
def test_cuda_n_valid_mid_chunk(cuda_device, kind):
    """n_valid inside a chunk (of several sub-tiles) and inside a sub-tile;
    k past n_valid brings the padding rows in row order."""
    rng = np.random.default_rng(5)
    words, _ = pt.pad_words(_words(rng, 300_000, 36, kind))
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    chunk_rows = pt._binary_plan(1, words.shape[0], 36, sms)[0]
    assert chunk_rows > pt.BINARY_TILE_N
    n_valid = 3 * chunk_rows + pt.BINARY_TILE_N + 77
    q = _words(rng, 9, 36).to(cuda_device)
    words = words.to(cuda_device)
    for k in (1, 20, n_valid - 1, n_valid, n_valid + 1, n_valid + 500):
        for qs in (q[:1], q):
            _check_kernel(qs, words, k, n_valid)


@pytest.mark.cuda
def test_cuda_k_is_every_row(cuda_device):
    rng = np.random.default_rng(6)
    words, n = pt.pad_words(_words(rng, 50_000, 36, "few"))
    q = _words(rng, 3, 36).to(cuda_device)
    words = words.to(cuda_device)
    for qs in (q[:1], q):
        _check_kernel(qs, words, words.shape[0], n - 100)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 64])
def test_cuda_word_width_edges(cuda_device, w):
    rng = np.random.default_rng(w)
    words, n = pt.pad_words(_words(rng, 200_000, w, "few" if w == 1 else "random"))
    q = _words(rng, 17, w).to(cuda_device)
    words = words.to(cuda_device)
    for k in (1, 20, 640, 5000):
        for qs in (q[:1], q[:9], q):
            _check_kernel(qs, words, k, n - 3)


@pytest.mark.cuda
@pytest.mark.parametrize("fit, q_count, group", [(5.5, 17, 5), (20.5, 40, 16)])
def test_cuda_query_groups_split_mid_batch(cuda_device, monkeypatch, fit, q_count, group):
    """A scratch limit that splits the batch into kernel calls of ``group``
    queries (17 = 5 + 5 + 5 + 2, one 8-query tile each; 40 = 16 + 16 + 8, two
    tiles then one), one launch counted per call of the wrapper."""
    rng = np.random.default_rng(8)
    words, n = pt.pad_words(_words(rng, 100_000, 36))
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    one = pt._binary_plan(1, words.shape[0], 36, sms)[2]
    monkeypatch.setattr(pt, "SCRATCH_MAX_BYTES", int(fit * one))
    assert pt._binary_plan(q_count, words.shape[0], 36, sms)[1] == group
    q = _words(rng, q_count, 36).to(cuda_device)
    words = words.to(cuda_device)
    for k in (1, 20, 640):
        _check_kernel(q, words, k, n)
