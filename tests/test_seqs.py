import numpy as np
import pytest

from consent_jax.io import seqs


def test_encode_decode_roundtrip():
    s = "ACGTACGTTTGCA"
    assert seqs.decode(seqs.encode(s)) == s


def test_encode_case_insensitive_and_n_maps_to_t():
    assert seqs.decode(seqs.encode("acgtN")) == "ACGTT"


def test_decode_with_solidity_mask():
    codes = seqs.encode("ACGT")
    solid = np.array([1, 0, 0, 1])
    assert seqs.decode(codes, solid) == "AcgT"


def test_revcomp():
    assert seqs.decode(seqs.revcomp(seqs.encode("AACGT"))) == "ACGTT"
    # involution
    x = seqs.encode("GATTACA")
    assert np.array_equal(seqs.revcomp(seqs.revcomp(x)), x)


def test_pack_unpack_2bit():
    rng = np.random.default_rng(0)
    for n in [0, 1, 3, 4, 5, 17, 1000]:
        codes = rng.integers(0, 4, n).astype(np.uint8)
        assert np.array_equal(seqs.unpack_2bit(seqs.pack_2bit(codes), n), codes)


def test_kmer_codes_matches_reference_numbering():
    # str2num numbering: A=0,C=1,G=2,T=3, big-endian over the k-mer.
    codes = seqs.encode("ACGT")
    k = seqs.kmer_codes(codes, 2)
    # AC=0*4+1, CG=1*4+2, GT=2*4+3
    assert k.tolist() == [1, 6, 11]


def test_kmer_roundtrip():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, 30).astype(np.uint8)
    ks = seqs.kmer_codes(codes, 9)
    for i, kv in enumerate(ks):
        assert np.array_equal(seqs.kmer_to_codes(int(kv), 9), codes[i : i + 9])


def test_kmer_short_sequence():
    assert len(seqs.kmer_codes(seqs.encode("ACG"), 9)) == 0
