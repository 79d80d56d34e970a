"""Native C++ host library vs Python implementations — must agree."""

import numpy as np
import pytest

from consent_jax import native
from consent_jax.core import dbg
from consent_jax.io import seqs
from consent_jax.ops import kmer as kmer_ops


pytestmark = pytest.mark.skipif(
    native.get_lib() is None, reason="native library unavailable"
)


def test_count_kmers_native_matches_host():
    rng = np.random.default_rng(0)
    frags = [rng.integers(0, 4, rng.integers(3, 60)).astype(np.uint8)
             for _ in range(12)]
    k = 5
    want = kmer_ops.count_kmers_host(frags, k)
    got = native.count_kmers_native(frags, k)
    assert np.array_equal(want, got)


def _random_case(seed, n=120, k=5):
    """Build a consensus with weak corrupted patches + counts from the
    true sequence."""
    rng = np.random.default_rng(seed)
    true = rng.integers(0, 4, n).astype(np.uint8)
    counts = np.zeros(4 ** k, dtype=np.int32)
    for km in seqs.kmer_codes(true, k):
        counts[km] += 10
    codes = true.copy()
    solid = np.ones(n, dtype=bool)
    for _ in range(rng.integers(0, 3)):
        a = int(rng.integers(0, n - 20))
        b = a + int(rng.integers(8, 18))
        codes[a:b] = rng.integers(0, 4, b - a)
        solid[max(0, a - 2) : min(n, b + 2)] = False
    return codes, solid, counts


@pytest.mark.parametrize("seed", range(25))
def test_polish_native_matches_python(seed):
    k = 5
    codes, solid, counts = _random_case(seed, k=k)
    py_c, py_s = dbg.polish_correction(codes, solid, counts, k, 4)
    res = native.polish_correction_native(codes, solid, counts, k, 4)
    assert res is not None
    na_c, na_s = res
    assert np.array_equal(py_c, na_c), seed
    assert np.array_equal(py_s, na_s), seed


def test_polish_native_head_tail():
    k = 5
    rng = np.random.default_rng(99)
    true = rng.integers(0, 4, 60).astype(np.uint8)
    counts = np.zeros(4 ** k, dtype=np.int32)
    for km in seqs.kmer_codes(true, k):
        counts[km] += 10
    codes = true.copy()
    codes[:4] = (codes[:4] + 1) % 4
    codes[-4:] = (codes[-4:] + 1) % 4
    solid = np.ones(60, dtype=bool)
    solid[:4] = False
    solid[-4:] = False
    py = dbg.polish_correction(codes, solid, counts, k, 4)
    na = native.polish_correction_native(codes, solid, counts, k, 4)
    assert np.array_equal(py[0], na[0])
    assert np.array_equal(py[1], na[1])


def test_assemble_windows_native_matches_python():
    from consent_jax import native
    from consent_jax.ops import consensus as cons_ops

    if native.get_lib() is None:
        import pytest
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(3)
    B, W, K = 17, 256, cons_ops.INS_CAP
    p = cons_ops.PackedVotes(
        col_base=rng.integers(0, 4, (B, W)).astype(np.int8),
        col_del=(rng.random((B, W)) < 0.1).astype(np.int8),
        ins_len=rng.integers(0, K + 1, (B, W)).astype(np.uint8)
        * (rng.random((B, W)) < 0.15),
        ins_pack=rng.integers(-(2 ** 31), 2 ** 31 - 1, (B, W)).astype(
            np.int64
        ).astype(np.int32),
        pre_len=rng.integers(0, K + 1, B).astype(np.int32),
        pre_pack=rng.integers(0, 2 ** 31 - 1, B).astype(np.int32),
        suf_len=rng.integers(0, K + 1, B).astype(np.int32),
        suf_pack=rng.integers(0, 2 ** 31 - 1, B).astype(np.int32),
    )
    w_lens = rng.integers(1, W + 1, B).tolist()
    got = native.assemble_windows_native(
        p.col_base, p.col_del, p.ins_len, p.ins_pack, p.pre_len,
        p.pre_pack, p.suf_len, p.suf_pack, w_lens,
    )
    want = cons_ops.assemble_consensus_batch(
        cons_ops.unpack_votes_host(p), w_lens
    )
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_host_post_window_native_matches_python(seed=5):
    """The consolidated native post chain must reproduce the Python
    stage composition (counts -> anchor gate -> solidity -> polish)
    byte for byte."""
    from consent_jax import native
    from consent_jax.core import dbg as dbg_mod
    from consent_jax.core.sparse_counts import SparseCounts
    from consent_jax.ops import kmer as kmer_ops

    if native.get_lib() is None:
        import pytest
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(seed)
    k, solid_thresh, max_branches, zone = 9, 4, 50, 3
    for case in range(40):
        tpl = rng.integers(0, 4, int(rng.integers(30, 400))).astype(
            np.uint8
        )
        n_frags = int(rng.integers(1, 12))
        frags = [tpl]
        for _ in range(n_frags - 1):
            f = tpl.copy()
            pos = rng.integers(0, len(f), max(1, len(f) // 10))
            f[pos] = (f[pos] + 1 + rng.integers(0, 3, len(pos))) % 4
            frags.append(f)
        cons = tpl.copy()
        if len(cons) > 20:
            pos = rng.integers(0, len(cons), len(cons) // 15 + 1)
            cons[pos] = (cons[pos] + 1) % 4
        min_anchors = int(rng.integers(1, 4))
        bmean_sup = min(8, len(frags) // 2)

        got = native.host_post_window_native(
            frags, cons, k, solid_thresh, max_branches, zone,
            min_anchors, bmean_sup,
        )
        assert got is not None
        g_codes, g_solid, g_sparse = got

        # python composition (mirrors engine._host_post_one fallback)
        dense = kmer_ops.count_kmers_host(frags, k)
        n_anch = kmer_ops.count_anchors_host(frags, k, bmean_sup)
        if n_anch < min_anchors:
            w_codes = np.asarray(frags[0], dtype=np.uint8)
            w_solid = np.ones(len(w_codes), dtype=bool)
        elif len(cons) >= k:
            solid = kmer_ops.solidity_mask(cons, dense, k, solid_thresh)
            w_codes, w_solid = dbg_mod.polish_correction(
                cons, solid, dense, k, solid_thresh, max_branches, zone
            )
        else:
            w_codes, w_solid = cons, np.zeros(len(cons), dtype=bool)
        w_sparse = SparseCounts.from_dense(dense)

        assert np.array_equal(g_codes, w_codes), f"case {case} codes"
        assert np.array_equal(g_solid, w_solid), f"case {case} solid"
        assert np.array_equal(g_sparse.kmers, w_sparse.kmers)
        assert np.array_equal(g_sparse.counts, w_sparse.counts)


def test_host_post_batch_native_matches_window_calls(seed=11):
    """host_post_batch (one ctypes call per window slice) must be
    byte-identical per window to host_post_window_native, including
    the sorted sparse-count keys/values and all three status paths
    (polish / anchor-gate template fallback / short consensus)."""
    rng = np.random.default_rng(seed)
    k, solid_thresh, max_branches, zone = 9, 4, 50, 3
    frag_lists, cons_list, sups, mins = [], [], [], []
    for case in range(60):
        tpl = rng.integers(0, 4, int(rng.integers(5, 400))).astype(
            np.uint8
        )
        n_frags = int(rng.integers(1, 12))
        frags = [tpl]
        for _ in range(n_frags - 1):
            f = tpl.copy()
            if len(f) >= 10:
                pos = rng.integers(0, len(f), max(1, len(f) // 10))
                f[pos] = (f[pos] + 1 + rng.integers(0, 3, len(pos))) % 4
            frags.append(f)
        cons = tpl.copy()
        if len(cons) > 20:
            pos = rng.integers(0, len(cons), len(cons) // 15 + 1)
            cons[pos] = (cons[pos] + 1) % 4
        frag_lists.append(frags)
        cons_list.append(cons)
        sups.append(min(8, len(frags) // 2))
        mins.append(int(rng.integers(1, 4)))

    # batch call runs with ONE min_anchors; group by value
    for ma in sorted(set(mins)):
        idx = [i for i, m in enumerate(mins) if m == ma]
        got = native.host_post_batch_native(
            [frag_lists[i] for i in idx],
            [cons_list[i] for i in idx],
            [sups[i] for i in idx],
            k, solid_thresh, max_branches, zone, ma,
        )
        assert got is not None
        for j, i in enumerate(idx):
            want = native.host_post_window_native(
                frag_lists[i], cons_list[i], k, solid_thresh,
                max_branches, zone, ma, sups[i],
            )
            assert want is not None
            g_codes, g_solid, g_sparse = got[j]
            w_codes, w_solid, w_sparse = want
            assert np.array_equal(g_codes, w_codes), f"win {i} codes"
            assert np.array_equal(g_solid, w_solid), f"win {i} solid"
            assert np.array_equal(g_sparse.kmers, w_sparse.kmers)
            assert np.array_equal(g_sparse.counts, w_sparse.counts)


@pytest.mark.parametrize("seed", range(3))
def test_posterior_spans_native_matches_device_aligner(seed):
    """The host stitch aligner (host.cpp posterior_spans_one, on the
    kernel's cell arithmetic) gives the device aligner's spans."""
    from consent_jax.pipeline import device_align
    from consent_jax.pipeline.stitch import STITCH_SCORING

    rng = np.random.default_rng(seed)
    qs, rs = [], []
    for _ in range(6):
        ref = rng.integers(0, 4, int(rng.integers(40, 300))).astype(np.uint8)
        lo = int(rng.integers(0, len(ref) // 3))
        q = ref[lo : lo + int(rng.integers(20, len(ref) - lo + 1))].copy()
        pos = rng.integers(0, len(q), len(q) // 10)
        q[pos] = (q[pos] + 1) % 4
        qs.append(np.concatenate([rng.integers(0, 4, 7).astype(np.uint8), q]))
        rs.append(ref)
    qs.append(np.array([1, 2], np.uint8))     # no positive alignment
    rs.append(np.array([0, 0, 3], np.uint8))
    got = native.posterior_spans_native(qs, rs, **STITCH_SCORING)
    assert got is not None
    want = device_align.device_batch_align(qs, rs)
    for k, s in enumerate(want):
        assert tuple(got[k]) == (s.q_begin, s.q_end, s.r_begin, s.r_end,
                                 int(s.valid)), k
