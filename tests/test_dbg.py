import numpy as np
import pytest

from consent_jax.core import dbg
from consent_jax.io import seqs


def counts_from(strings, k, weight=10):
    n = 4 ** k
    counts = np.zeros(n, dtype=np.int32)
    for s in strings:
        for km in seqs.kmer_codes(seqs.encode(s), k):
            counts[km] += weight
    return counts


def km(s):
    return dbg._codes_to_kmer(seqs.encode(s))


def test_neighbors_right_order_and_threshold():
    k = 3
    counts = np.zeros(64, dtype=np.int32)
    counts[km("CGA")] = 5
    counts[km("CGT")] = 9
    counts[km("CGG")] = 2  # below threshold
    out = dbg.neighbors_right(km("ACG"), k, counts, solid=4)
    assert out == [km("CGT"), km("CGA")]


def test_neighbors_left():
    k = 3
    counts = np.zeros(64, dtype=np.int32)
    counts[km("TAC")] = 7
    counts[km("GAC")] = 3  # below
    out = dbg.neighbors_left(km("ACG"), k, counts, solid=4)
    assert out == [km("TAC")]


def test_extend_left_follows_unique_path():
    k = 4
    true = "ACGTTGCA"
    counts = counts_from([true], k)
    # start from the last k bases, extend left by 4
    codes = seqs.encode(true[4:])
    ext, dist = dbg.extend_left(counts, k, 4, codes, solid=4)
    assert dist == 4
    assert seqs.decode(ext) == true[:4]


def test_extend_left_stops_at_branch():
    k = 4
    counts = counts_from(["ACGTTGCA", "TCGTTGCA"], k)  # two left paths
    codes = seqs.encode("TTGCA")
    # extending left: GTTGC unique? build from "CGTTG" kmers both A/T prefix
    ext, dist = dbg.extend_left(counts, k, 4, codes, solid=4)
    # paths diverge 3 steps back (ACGT vs TCGT): dist < 4
    assert dist < 4


def test_extend_right_takes_best_branch():
    k = 4
    counts = counts_from(["TGCAACGG"], k) + counts_from(["TGCAT"], k, weight=3)
    codes = seqs.encode("TGCA")
    ext, dist = dbg.extend_right(counts, k, 4, codes, solid=3)
    # branch at TGCA -> GCAA (10) vs GCAT (3): takes best
    assert seqs.decode(ext)[0] == "A"
    assert dist == 4


def test_link_unique_path():
    k = 5
    true = "ACGTTGCAACGGTTAACC"
    counts = counts_from([true], k)
    src, dst = km(true[:5]), km(true[-5:])
    out = dbg.link(
        counts, src, dst, k, set(), dbg._Budget(), 0,
        [int(c) for c in seqs.encode(true[:5])],
        max_size=30, solid=4,
    )
    assert out is not None
    assert seqs.decode(np.array(out, dtype=np.uint8)) == true


def test_link_with_decoy_branch():
    k = 5
    true = "ACGTTGCAACGGTTAACC"
    decoy = "ACGTTGCATGGA"  # branches after GCA, dead-ends
    counts = counts_from([true, decoy], k)
    src, dst = km(true[:5]), km(true[-5:])
    out = dbg.link(
        counts, src, dst, k, set(), dbg._Budget(), 0,
        [int(c) for c in seqs.encode(true[:5])],
        max_size=30, solid=4,
    )
    assert out is not None
    assert seqs.decode(np.array(out, dtype=np.uint8)) == true


def test_link_respects_distance_budget():
    k = 5
    true = "ACGTTGCAACGGTTAACC"
    counts = counts_from([true], k)
    src, dst = km(true[:5]), km(true[-5:])
    out = dbg.link(
        counts, src, dst, k, set(), dbg._Budget(), 0,
        [int(c) for c in seqs.encode(true[:5])],
        max_size=5, solid=4,  # path needs 13 extensions
    )
    assert out is None


def test_next_src_next_dst():
    #            0123456789
    mask = np.array([1, 1, 1, 1, 0, 0, 1, 1, 1, 1], dtype=bool)
    # next_src with n=3: scans through solid run, stops at weak after >=3
    assert dbg.next_src(mask, 0, 3) == 3
    assert dbg.next_dst(mask, 4, 3) == 8
    assert dbg.next_src(mask, 4, 3) == 9  # run 6-9 reaches end: nb>=3 -> i-1
    assert dbg.next_dst(mask, 0, 5) == -1


def test_get_anchors_unique_and_ranked():
    k = 3
    src_zone = seqs.encode("ACGTAC")  # kmers ACG CGT GTA TAC; AC? ACG unique...
    dst_zone = seqs.encode("GGTTGG")  # GGT GTT TTG TGG all unique
    counts = np.zeros(64, dtype=np.int32)
    counts[km("ACG")] = 10
    counts[km("GGT")] = 9
    counts[km("TAC")] = 1
    anchors = dbg.get_anchors(counts, src_zone, dst_zone, k, 3)
    assert len(anchors) == 3
    # best pair: ACG + GGT = 19
    skm, dkm, sp, dp = anchors[0]
    assert skm == km("ACG") and dkm == km("GGT")
    assert sp == 0 and dp == 0


def test_polish_correction_repairs_weak_region():
    k = 5
    true = "TGGTGTTAACCTTACTATACTCCCGCTCCGGGGT"
    counts = counts_from([true], k)
    # consensus: middle region corrupted + weak; flanks solid
    bad = true[:12] + "TTTT" + true[18:]
    codes = seqs.encode(bad)
    solid = np.ones(len(codes), dtype=bool)
    solid[10:22] = False  # weak zone covering the corruption
    out_c, out_s = dbg.polish_correction(codes, solid, counts, k, solid_thresh=4)
    assert seqs.decode(out_c) == true
    assert out_s.all()


def test_polish_correction_weak_head_extension():
    k = 5
    true = "TTGGCTCATATGAACAAGTCT"
    counts = counts_from([true], k)
    # head garbage, solid tail
    bad = "TTT" + true[3:]
    codes = seqs.encode(bad)
    solid = np.ones(len(codes), dtype=bool)
    solid[:3] = False
    out_c, out_s = dbg.polish_correction(codes, solid, counts, k, solid_thresh=4)
    assert seqs.decode(out_c) == true


def test_polish_correction_weak_tail_extension():
    k = 5
    true = "TTGGCTCATATGAACAAGTCT"
    counts = counts_from([true], k)
    bad = true[:-3] + "AAA"
    codes = seqs.encode(bad)
    solid = np.ones(len(codes), dtype=bool)
    solid[-3:] = False
    out_c, out_s = dbg.polish_correction(codes, solid, counts, k, solid_thresh=4)
    assert seqs.decode(out_c) == true


def test_polish_correction_no_weak_regions_is_identity():
    k = 5
    true = "TTGGCTCATATGAACAAGTCT"
    counts = counts_from([true], k)
    codes = seqs.encode(true)
    solid = np.ones(len(codes), dtype=bool)
    out_c, out_s = dbg.polish_correction(codes, solid, counts, k, 4)
    assert seqs.decode(out_c) == true
    assert out_s.all()
