import numpy as np
import pytest

from consent_jax.io import seqs
from consent_jax.overlap import minimizer as mz
from consent_jax.testing import simulate


def test_minimizers_deterministic_and_within_range():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, 300).astype(np.uint8)
    p = mz.OverlapParams()
    h1, pos1, s1 = mz.minimizers(codes, p)
    h2, pos2, s2 = mz.minimizers(codes, p)
    assert np.array_equal(pos1, pos2)
    assert (pos1 >= 0).all() and (pos1 <= len(codes) - p.k).all()
    # density ~ 2/(w+1)
    assert len(pos1) > (len(codes) - p.k) / (p.w * 2)


def test_minimizers_strand_symmetric():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, 400).astype(np.uint8)
    p = mz.OverlapParams()
    h_f, _, _ = mz.minimizers(codes, p)
    h_r, _, _ = mz.minimizers(seqs.revcomp(codes), p)
    # canonical hashing: same minimizer hash sets on both strands
    assert set(h_f.tolist()) == set(h_r.tolist())


def test_all_vs_all_finds_true_overlaps():
    genome, reads = simulate.simulate(
        genome_len=6000, coverage=8.0, read_len=1500,
        error_rate=0.08, seed=3,
    )
    named = [(r.name, r.codes) for r in reads]
    piles = {p.q_name: p for p in mz.all_vs_all_piles(named)}

    # ground truth pairs with >=500bp genomic overlap
    found, missed = 0, 0
    by_name = {r.name: r for r in reads}
    for a in reads:
        for b in reads:
            if a.name >= b.name:
                continue
            o = min(a.g_end, b.g_end) - max(a.g_beg, b.g_beg)
            if o < 500:
                continue
            hit = (
                a.name in piles and b.name in piles[a.name].t_names
            ) or (
                b.name in piles and a.name in piles[b.name].t_names
            )
            if hit:
                found += 1
            else:
                missed += 1
    assert found / max(1, found + missed) > 0.9, (found, missed)


def test_overlap_coords_roughly_correct():
    genome, reads = simulate.simulate(
        genome_len=5000, coverage=6.0, read_len=1800,
        error_rate=0.06, seed=7, with_reverse=False,
    )
    named = [(r.name, r.codes) for r in reads]
    by_name = {r.name: r for r in reads}
    for pile in mz.all_vs_all_piles(named):
        a = by_name[pile.q_name]
        for i, t_name in enumerate(pile.t_names):
            b = by_name[t_name]
            g0 = max(a.g_beg, b.g_beg)
            g1 = min(a.g_end, b.g_end)
            if g1 - g0 < 300:
                continue
            # query span should roughly cover the genomic intersection
            true_qs = simulate._project(a, g0)
            true_qe = simulate._project(a, g1 - 1)
            qs = int(pile.ov["q_start"][i])
            qe = int(pile.ov["q_end"][i])
            assert abs(qs - true_qs) < 250, (qs, true_qs)
            assert abs(qe - true_qe) < 250, (qe, true_qe)


def test_map_to_targets_contig_is_query():
    genome, reads = simulate.simulate(
        genome_len=4000, coverage=6.0, read_len=1200,
        error_rate=0.06, seed=11,
    )
    contig = ("contig1", genome)
    named = [(r.name, r.codes) for r in reads]
    piles = list(mz.map_to_targets_piles([contig], named))
    assert len(piles) == 1
    p = piles[0]
    assert p.q_name == "contig1"
    assert p.q_len == len(genome)
    assert len(p) > len(reads) * 0.7


def test_rc_kmers_bit_trick_matches_recompute():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 600).astype(np.uint8)
    for k in (9, 15, 21, 31):
        fwd = mz._kmers_u64(codes, k)
        rc = mz._rc_kmers_u64(fwd, k)
        want = mz._kmers_u64(seqs.revcomp(codes), k)[::-1]
        assert np.array_equal(rc, want), k


def test_block_mapping_equals_per_query():
    genome, reads = simulate.simulate(
        genome_len=20_000, coverage=8.0, read_len=2000,
        error_rate=0.08, seed=13,
    )
    named = [(r.name, r.codes) for r in reads]
    index = mz.MinimizerIndex(mz.OverlapParams())
    for nm, c in named:
        index.add(nm, c)
    index.build()
    block = mz.map_block_arrays(index, named, skip_self=True)
    assert len(block) == len(named)
    n_some = 0
    for (nm, c), m in zip(named, block):
        one = mz.map_query_arrays(index, nm, c, skip_self=True)
        if m is None:
            assert one is None
            continue
        n_some += 1
        for key in m:
            if key == "q_len":
                assert m[key] == one[key]
            else:
                assert np.array_equal(m[key], one[key]), (nm, key)
    assert n_some > len(named) // 2


def test_join_matches_searchsorted():
    rng = np.random.default_rng(2)
    genome, reads = simulate.simulate(
        genome_len=15_000, coverage=6.0, read_len=1500,
        error_rate=0.08, seed=4,
    )
    index = mz.MinimizerIndex(mz.OverlapParams())
    for r in reads:
        index.add(r.name, r.codes)
    index.build()
    qh = np.concatenate([
        index.h[rng.integers(0, len(index.h), 200)],
        rng.integers(0, 2 ** 63, 200).astype(np.uint64),
    ])
    lo, hi = index.join(qh)
    want_lo = np.searchsorted(index.h, qh, side="left")
    want_hi = np.searchsorted(index.h, qh, side="right")
    assert np.array_equal(lo, want_lo)
    assert np.array_equal(hi, want_hi)
