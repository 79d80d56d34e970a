import numpy as np
import pytest

import jax.numpy as jnp

from consent_jax.core import npalign
from consent_jax.io import seqs
from consent_jax.ops import align as align_ops


def pad_to(x, L):
    out = np.zeros(L, dtype=np.uint8)
    out[: len(x)] = x
    return out


def run_summary(qs, rs, Lq, Lr, sc=align_ops.Scoring()):
    q = jnp.array([pad_to(x, Lq) for x in qs])
    ql = jnp.array([len(x) for x in qs], jnp.int32)
    r = jnp.array([pad_to(x, Lr) for x in rs])
    rl = jnp.array([len(x) for x in rs], jnp.int32)
    return align_ops.posterior_summary(q, ql, r, rl, sc)


def random_pair(rng, n=40, mut=0.15):
    true = rng.integers(0, 4, n).astype(np.uint8)
    q = []
    for b in true:
        p = rng.random()
        if p < mut / 3:
            continue  # deletion
        elif p < 2 * mut / 3:
            q.append(rng.integers(0, 4))  # substitution
        elif p < mut:
            q.extend([b, rng.integers(0, 4)])  # insertion
        else:
            q.append(b)
    return np.array(q, dtype=np.uint8), true


@pytest.mark.parametrize("seed", range(15))
def test_opt_score_matches_numpy_oracle(seed):
    rng = np.random.default_rng(seed)
    q, r = random_pair(rng, n=int(rng.integers(10, 60)))
    res = run_summary([q], [r], 90, 70)
    oracle = npalign.local_align(q, r)
    assert int(res.opt[0]) == oracle.opt


@pytest.mark.parametrize("seed", range(10))
def test_oracle_path_cells_within_summary(seed):
    """Each matched cell (i, j) of one optimal traceback must fall in
    the summary's [i_first, i_last] bracket of its column (the summary
    folds the union of optimal paths)."""
    rng = np.random.default_rng(100 + seed)
    q, r = random_pair(rng, n=int(rng.integers(10, 50)))
    res = run_summary([q], [r], 80, 60)
    matched = np.asarray(res.matched[0])
    i_first = np.asarray(res.i_first[0])
    i_last = np.asarray(res.i_last[0])
    oracle = npalign.local_align(q, r)
    for (i, j) in oracle.pairs:
        assert matched[j], f"column {j} not matched"
        assert i_first[j] <= i <= i_last[j]


def test_identical_sequences_match_diagonal():
    q = seqs.encode("ACGTACGGTTCA")
    res = run_summary([q], [q], 20, 20)
    matched = np.asarray(res.matched[0])
    i_first = np.asarray(res.i_first[0])
    i_last = np.asarray(res.i_last[0])
    for j in range(len(q)):
        assert matched[j]
        assert i_first[j] == j == i_last[j]


def test_empty_lane():
    q = seqs.encode("ACGT")
    res = run_summary([q, np.empty(0, np.uint8)], [q, q], 10, 10)
    assert int(res.opt[1]) == 0
    assert not np.asarray(res.matched[1]).any()


def test_no_alignment_all_mismatch():
    q = seqs.encode("AAAA")
    r = seqs.encode("CCCC")
    res = run_summary([q], [r], 8, 8)
    assert int(res.opt[0]) == 0
    assert not np.asarray(res.matched[0]).any()


def test_spans_simple():
    r = seqs.encode("TTTTACGTACGTTTTT")
    q = seqs.encode("ACGTACG")
    res = run_summary([q], [r], 10, 20)
    spans = align_ops.summary_spans(res)
    assert bool(spans.valid[0])
    assert int(spans.q_begin[0]) == 0
    assert int(spans.q_end[0]) == 6
    assert int(spans.r_begin[0]) == 4
    assert int(spans.r_end[0]) == 10


@pytest.mark.parametrize("seed", range(8))
def test_batch_matches_individual(seed):
    rng = np.random.default_rng(200 + seed)
    pairs = [random_pair(rng, n=30) for _ in range(5)]
    res = run_summary([p[0] for p in pairs], [p[1] for p in pairs], 60, 40)
    for lane, (q, r) in enumerate(pairs):
        oracle = npalign.local_align(q, r)
        assert int(res.opt[lane]) == oracle.opt


def test_gap_cost_model():
    r = seqs.encode("ACGTAACGT")
    q = seqs.encode("ACGTCGT")
    # 7 matches * 2 - (open 4 + ext 2) = 14 - 6 = 8
    res = run_summary([q], [r], 12, 12)
    assert int(res.opt[0]) == 8
