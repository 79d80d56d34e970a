import numpy as np
import pytest

from consent_jax.core import windows as W
from consent_jax.io import seqs
from consent_jax.io.paf import OVERLAP_DTYPE, Pile


def make_ov(rows):
    """rows: list of (q_len, q_start, q_end, strand, t_len, t_start, t_end,
    matches)"""
    return np.array(
        [r + (0, 0) for r in rows],
        dtype=OVERLAP_DTYPE,
    )


def scalar_window_positions(q_len, cov, min_support, window_size, overlap):
    """Direct scalar transcription of the reference scan semantics
    (src/alignmentWindows.cpp:27-85) used as an oracle for the
    vectorized implementation."""
    out = []
    cur_len, beg, i = 0, 0, 0
    while i < q_len:
        if cur_len >= window_size:
            out.append((beg, beg + cur_len - 1))
            if overlap:
                i -= overlap
            beg = i
            cur_len = 0
        if cov[i] < min_support:
            cur_len = 0
            i += 1
            beg = i
        else:
            cur_len += 1
            i += 1

    pushed = False
    end = q_len - 1
    cur_len = 0
    i = q_len - 1
    while i > 0 and not pushed:
        if cur_len >= window_size:
            out.append((end - cur_len + 1, end))
            pushed = True
            end = i
            cur_len = 0
        if cov[i] < min_support:
            cur_len = 0
            i -= 1
            end = i
        else:
            cur_len += 1
            i -= 1
    return out


def test_coverage_inclusive_ends():
    ov = make_ov([(10, 2, 5, False, 10, 0, 3, 4)])
    cov = W.coverage(10, ov)
    assert cov.tolist() == [0, 0, 1, 1, 1, 1, 0, 0, 0, 0]


def test_coverage_stacks():
    ov = make_ov(
        [(8, 0, 7, False, 8, 0, 7, 8), (8, 3, 4, False, 8, 0, 1, 2)]
    )
    assert W.coverage(8, ov).tolist() == [1, 1, 1, 2, 2, 1, 1, 1]


@pytest.mark.parametrize("seed", range(20))
def test_window_positions_matches_scalar_oracle(seed):
    rng = np.random.default_rng(seed)
    q_len = int(rng.integers(5, 400))
    wsize = int(rng.integers(5, 60))
    overlap = int(rng.integers(0, max(1, wsize - 1)))
    min_support = int(rng.integers(1, 4))
    # random blocky coverage
    cov = np.zeros(q_len, dtype=np.int64)
    for _ in range(rng.integers(0, 6)):
        a = int(rng.integers(0, q_len))
        b = int(rng.integers(a, q_len))
        cov[a : b + 1] += int(rng.integers(1, 4))
    got = W.window_positions(q_len, cov, min_support, wsize, overlap)
    want = scalar_window_positions(q_len, cov, min_support, wsize, overlap)
    assert got == want


def test_window_positions_simple_run():
    # full coverage, length 2000, W=500, o=50
    cov = np.full(2000, 5)
    got = W.window_positions(2000, cov, 3, 500, 50)
    # forward: starts 0, 450, 900, 1350 (end 1849 <= 1998); 1800 -> end 2299 no
    # right-anchored: (1500, 1999)
    assert got == [(0, 499), (450, 949), (900, 1399), (1350, 1849), (1500, 1999)]


def test_window_positions_duplicate_right_anchor():
    # run [0,949]: forward gives (0,499),(450,949); right-anchored (450,949)
    cov = np.zeros(2000, dtype=np.int64)
    cov[0:950] = 5
    got = W.window_positions(2000, cov, 3, 500, 50)
    assert got == [(0, 499), (450, 949), (450, 949)]


def test_window_positions_exact_length_sequence_emits_nothing():
    # sequence of exactly window_size with full coverage: forward pass
    # can't push (touches last base), right pass guard i>0 fails.
    cov = np.full(500, 9)
    assert W.window_positions(500, cov, 3, 500, 50) == []


def test_window_positions_no_coverage():
    cov = np.zeros(1000, dtype=np.int64)
    assert W.window_positions(1000, cov, 3, 500, 50) == []


def _pile_for_clip(tpl_seq, targets, rows):
    """Build a Pile + sequences dict. rows use names t0, t1, ..."""
    ov = make_ov(rows)
    names = [f"t{i}" for i in range(len(rows))]
    sequences = {"q": seqs.encode(tpl_seq)}
    for n, s in zip(names, targets):
        sequences[n] = seqs.encode(s)
    return Pile(q_name="q", t_names=names, ov=ov), sequences


def test_clip_spanning_overlap():
    # Window [4, 9] on a 20-base template; overlap spans the window.
    tpl = "ACGTACGTACGTACGTACGT"
    tgt = "ACGTACGTACGTACGTACGT"
    pile, seqmap = _pile_for_clip(
        tpl, [tgt], [(20, 0, 19, False, 20, 0, 19, 10)]
    )
    frags = W.clip_fragments(pile, seqmap, 4, 9, 3)
    assert seqs.decode(frags[0]) == tpl[4:10]  # template first
    # spanning: shift = 4, slab = whole target, cut [4:10]
    assert seqs.decode(frags[1]) == tgt[4:10]


def test_clip_internal_overlap_excluded():
    # alignment strictly inside the window is not admitted
    tpl = "A" * 30
    pile, seqmap = _pile_for_clip(
        tpl, ["C" * 30], [(30, 10, 14, False, 30, 10, 14, 5)]
    )
    frags = W.clip_fragments(pile, seqmap, 5, 24, 3)
    assert len(frags) == 1  # template only


def test_clip_left_clipped_overlap():
    # overlap starts inside window, extends past its right end
    tpl = "ACGTACGTACGTACGTACGTACGT"  # 24
    tgt = "GGGGCCCCAAAATTTT"  # 16
    # q_start=8, q_end=23, t_start=2, t_end=15
    pile, seqmap = _pile_for_clip(
        tpl, [tgt], [(24, 8, 23, False, 16, 2, 15, 10)]
    )
    # window [4, 13]: q_beg=4 < q_start=8 -> left-clip branch
    frags = W.clip_fragments(pile, seqmap, 4, 13, 3)
    # t_beg = max(0, 2 - (8-4)) = 0; length = min(10, min(15, 0+9)-0+1)=10
    assert seqs.decode(frags[1]) == tgt[0:10]


def test_clip_right_clipped_overlap():
    tpl = "ACGTACGTACGTACGTACGTACGT"  # 24
    tgt = "GGGGCCCCAAAATTTT"  # 16
    # q_start=0, q_end=9, t_start=0, t_end=9
    pile, seqmap = _pile_for_clip(
        tpl, [tgt], [(24, 0, 9, False, 16, 0, 9, 10)]
    )
    # window [4, 13]: q_end_al=9 < 13 -> right-clip branch
    # t_end = min(15, 9 + (13-9)) = 13; length = min(10, 13 - max(0,13-10+1)+1)=10
    # shift = 4; slab = tgt[0:14]; frag = slab[4:14]
    frags = W.clip_fragments(pile, seqmap, 4, 13, 3)
    assert seqs.decode(frags[1]) == tgt[4:14]


def test_clip_reverse_strand_revcomps():
    tpl = "A" * 12
    tgt = "ACGTACGTACGT"
    pile, seqmap = _pile_for_clip(
        tpl, [tgt], [(12, 0, 11, True, 12, 0, 11, 10)]
    )
    frags = W.clip_fragments(pile, seqmap, 2, 7, 3)
    rc = seqs.decode(seqs.revcomp(seqs.encode(tgt)))
    assert seqs.decode(frags[1]) == rc[2:8]


def test_clip_short_fragment_dropped():
    tpl = "A" * 30
    tgt = "C" * 30
    # admitted but produces a fragment shorter than mer_size
    pile, seqmap = _pile_for_clip(
        tpl, [tgt], [(30, 0, 10, False, 30, 0, 2, 5)]
    )
    frags = W.clip_fragments(pile, seqmap, 8, 27, 9)
    assert len(frags) == 1


def test_clip_window_off_template_returns_empty():
    tpl = "A" * 10
    pile, seqmap = _pile_for_clip(
        tpl, ["C" * 10], [(20, 0, 9, False, 10, 0, 9, 5)]
    )
    # q_len in PAF says 20 but the stored template is 10 long
    assert W.clip_fragments(pile, seqmap, 5, 14, 3) == []
