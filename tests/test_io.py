import io
import textwrap

import numpy as np
import pytest

from consent_jax.io import fasta, paf, seqs


def test_iter_fasta_multiline(tmp_path):
    p = tmp_path / "r.fasta"
    p.write_text(">read1 extra comment\nACGT\nACGT\n>read2\nTTTT\n")
    recs = list(fasta.iter_fastx(str(p)))
    assert recs == [("read1", "ACGTACGT"), ("read2", "TTTT")]


def test_iter_fastq(tmp_path):
    p = tmp_path / "r.fastq"
    p.write_text("@read1 c\nACGT\n+\nIIII\n@read2\nGG\nGG\n+\nIII\nI\n")
    recs = list(fasta.iter_fastx(str(p)))
    assert recs == [("read1", "ACGT"), ("read2", "GGGG")]


def test_read_index(tmp_path):
    p = tmp_path / "r.fasta"
    p.write_text(">a\nacgt\n>b\nTTTT\n")
    idx = fasta.ReadIndex.from_file(str(p))
    assert seqs.decode(idx["a"]) == "ACGT"
    assert idx.length("b") == 4
    assert "c" not in idx


PAF_LINES = textwrap.dedent(
    """\
    r1\t100\t10\t90\t+\tr2\t120\t5\t85\t60\t80\t255
    r1\t100\t0\t50\t-\tr3\t200\t100\t150\t45\t50\t255
    r1\t100\t20\t80\t+\tr4\t90\t0\t60\t50\t60\t255
    r2\t120\t0\t120\t+\tr1\t100\t0\t100\t90\t120\t255
    """
)


def test_parse_line_inclusive_ends():
    q, t, row = paf.parse_line("r1\t100\t10\t90\t+\tr2\t120\t5\t85\t60\t80\t255")
    assert q == "r1" and t == "r2"
    assert row[2] == 89  # q_end inclusive
    assert row[6] == 84  # t_end inclusive
    assert row[3] is False  # '+' strand


def test_iter_piles_grouping_and_sort():
    piles = list(paf.iter_piles(io.StringIO(PAF_LINES), max_support=10))
    assert [p.q_name for p in piles] == ["r1", "r2"]
    p1 = piles[0]
    # sorted by matches desc: 60 (r2), 50 (r4), 45 (r3)
    assert p1.t_names == ["r2", "r4", "r3"]
    assert p1.ov["matches"].tolist() == [60, 50, 45]
    assert p1.q_len == 100


def test_iter_piles_max_support_truncation():
    piles = list(paf.iter_piles(io.StringIO(PAF_LINES), max_support=2))
    assert len(piles[0]) == 2
    assert piles[0].t_names == ["r2", "r4"]


def test_iter_piles_stable_tiebreak():
    lines = (
        "q\t50\t0\t10\t+\ta\t50\t0\t10\t30\t10\t255\n"
        "q\t50\t0\t10\t+\tb\t50\t0\t10\t30\t10\t255\n"
        "q\t50\t0\t10\t+\tc\t50\t0\t10\t40\t10\t255\n"
    )
    (p,) = paf.iter_piles(io.StringIO(lines), max_support=10)
    assert p.t_names == ["c", "a", "b"]


def test_reformat_line_swaps_query_target():
    line = "r1\t100\t10\t90\t-\tc1\t5000\t40\t120\t60\t80\t255"
    out = paf.reformat_line(line)
    assert out.split("\t") == [
        "c1", "5000", "40", "120", "-", "r1", "100", "10", "90", "60", "80", "255",
    ]


def test_sort_by_target_c_collation(tmp_path):
    src = tmp_path / "in.paf"
    # C collation: "B" < "a"; stable within key
    src.write_text(
        "q1\t9\t0\t5\t+\ta\t9\t0\t5\t5\t5\t255\n"
        "q2\t9\t0\t5\t+\tB\t9\t0\t5\t5\t5\t255\n"
        "q3\t9\t0\t5\t+\ta\t9\t0\t5\t5\t5\t255\n"
    )
    dst = tmp_path / "out.paf"
    paf.sort_by_target(str(src), str(dst))
    qs = [ln.split("\t")[0] for ln in dst.read_text().splitlines()]
    assert qs == ["q2", "q1", "q3"]


def test_group_paf_by_query(tmp_path):
    src = tmp_path / "in.paf"
    src.write_text(
        "a\t9\t0\t5\t+\tx\t9\t0\t5\t5\t5\t255\n"
        "b\t9\t0\t5\t+\tx\t9\t0\t5\t5\t5\t255\n"
        "a\t9\t1\t6\t+\ty\t9\t0\t5\t5\t5\t255\n"
    )
    dst = tmp_path / "out.paf"
    paf.group_paf_by_query(str(src), str(dst))
    qs = [ln.split("\t")[0] for ln in dst.read_text().splitlines()]
    assert qs == ["a", "a", "b"]
