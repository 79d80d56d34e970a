import numpy as np
import pytest

from consent_jax.core import postprocess as pp
from consent_jax.io import seqs


def mk(seq_case):
    """'AcGt' -> (codes, solid) with uppercase == solid."""
    codes = seqs.encode(seq_case)
    solid = np.array([c.isupper() for c in seq_case])
    return codes, solid


def test_trim_read_n1():
    codes, solid = mk("acGTACgta")
    c, s = pp.trim_read(codes, solid, 1)
    assert seqs.decode(c, s) == "GTAC"


def test_trim_read_all_weak_returns_empty():
    codes, solid = mk("acgt")
    c, s = pp.trim_read(codes, solid, 1)
    assert len(c) == 0


def test_trim_read_single_solid_base_dropped():
    # beg == end -> "" (the reference's strict end > beg check)
    codes, solid = mk("aaAaa")
    c, s = pp.trim_read(codes, solid, 1)
    assert len(c) == 0


def test_trim_read_run_length():
    codes, solid = mk("aAAaaAAAa")
    c, s = pp.trim_read(codes, solid, 3)
    assert seqs.decode(c, s) == "AAA"


def test_drop_read_threshold():
    codes, solid = mk("A" + "a" * 10)     # ~9% solid
    assert pp.drop_read(solid)
    codes, solid = mk("AA" + "a" * 8)     # 20% solid
    assert not pp.drop_read(solid)
    assert pp.drop_read(np.zeros(0, dtype=bool))


def test_split_read_at_large_gaps():
    codes, solid = mk("AAAA" + "a" * 6 + "CCCC" + "a" * 2 + "GGGG")
    pieces = pp.split_read(codes, solid, window_size=5)
    assert len(pieces) == 2
    assert seqs.decode(pieces[0][0], pieces[0][1]) == "AAAA"
    # the reference's final piece always drops the last solid base
    # (utils.cpp:157-161; fuzz-diffed in test_reference_diff.py)
    assert seqs.decode(pieces[1][0], pieces[1][1]) == "CCCCaaGGG"


def test_split_read_no_gaps():
    codes, solid = mk("aAAAAa")
    pieces = pp.split_read(codes, solid, window_size=5)
    assert len(pieces) == 1
    assert seqs.decode(pieces[0][0], pieces[0][1]) == "AAA"


def test_split_read_all_weak():
    # one EMPTY piece, not zero pieces (reference substr(len, ...))
    codes, solid = mk("aaaa")
    pieces = pp.split_read(codes, solid, 5)
    assert len(pieces) == 1 and len(pieces[0][0]) == 0
