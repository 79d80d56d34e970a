"""CLI smoke tests driving the full drivers on tiny simulated data."""

import numpy as np
import pytest

from consent_jax import cli
from consent_jax.io import seqs
from consent_jax.io.fasta import iter_fastx
from consent_jax.testing import metrics, simulate


@pytest.fixture(scope="module")
def small_dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    genome, reads = simulate.simulate(
        genome_len=2000, coverage=10.0, read_len=700,
        error_rate=0.08, seed=21,
    )
    reads_fa = tmp / "reads.fasta"
    with open(reads_fa, "w") as f:
        for r in reads:
            f.write(f">{r.name}\n{seqs.decode(r.codes)}\n")
    draft, _ = simulate.mutate(genome, np.random.default_rng(1), 0.02)
    asm_fa = tmp / "draft.fasta"
    with open(asm_fa, "w") as f:
        f.write(f">contig1\n{seqs.decode(draft)}\n")
    return tmp, genome, reads, draft, reads_fa, asm_fa


def test_cli_correct(small_dataset):
    tmp, genome, reads, draft, reads_fa, asm_fa = small_dataset
    out = tmp / "corrected.fasta"
    rc = cli.main_correct([
        "--in", str(reads_fa), "--out", str(out),
        "--windowSize", "200", "--windowOverlap", "20",
        "--overlapper", "native",
    ])
    assert rc == 0
    recs = dict(iter_fastx(str(out)))
    assert len(recs) >= len(reads) * 0.5
    by_name = {r.name: r for r in reads}
    ids = []
    for name, seq in recs.items():
        r = by_name[name]
        truth = genome[r.g_beg : r.g_end]
        if r.reverse:
            truth = seqs.revcomp(truth)
        ids.append(metrics.identity(seqs.encode(seq), truth))
    assert float(np.mean(ids)) > 0.94


def test_cli_polish(small_dataset):
    tmp, genome, reads, draft, reads_fa, asm_fa = small_dataset
    out = tmp / "polished.fasta"
    rc = cli.main_polish([
        "--contigs", str(asm_fa), "--reads", str(reads_fa),
        "--out", str(out),
        "--windowSize", "200", "--windowOverlap", "20",
        "--overlapper", "native",
    ])
    assert rc == 0
    recs = dict(iter_fastx(str(out)))
    assert "contig1" in recs
    polished = seqs.encode(recs["contig1"])
    assert metrics.identity(polished, genome) > metrics.identity(
        draft, genome
    )


def test_cli_correct_from_paf(small_dataset):
    """Drive the --paf input path (the reference's minimap2 contract)."""
    tmp, genome, reads, draft, reads_fa, asm_fa = small_dataset
    # synthesize a PAF from exact overlaps
    paf = tmp / "overlaps.paf"
    with open(paf, "w") as f:
        for a in reads:
            for b in reads:
                if a.name == b.name:
                    continue
                ov = simulate.true_overlap(a, b)
                if ov is None:
                    continue
                (qlen, qs, qe, strand, tlen, ts, te, m, blk, mq) = ov
                f.write(
                    f"{a.name}\t{qlen}\t{qs}\t{qe + 1}\t"
                    f"{'-' if strand else '+'}\t{b.name}\t{tlen}\t{ts}\t"
                    f"{te + 1}\t{m}\t{blk}\t{mq}\n"
                )
    out = tmp / "corrected_paf.fasta"
    rc = cli.main_correct([
        "--in", str(reads_fa), "--out", str(out), "--paf", str(paf),
        "--windowSize", "200", "--windowOverlap", "20",
    ])
    assert rc == 0
    recs = dict(iter_fastx(str(out)))
    assert len(recs) >= len(reads) * 0.5


def test_cli_correct_resume(small_dataset, tmp_path):
    """Interrupted-run resume: a completed chunk is not recomputed and
    the final output matches a fresh run."""
    tmp, genome, reads, draft, reads_fa, asm_fa = small_dataset
    out1 = tmp_path / "fresh.fasta"
    cli.main_correct([
        "--in", str(reads_fa), "--out", str(out1),
        "--windowSize", "200", "--windowOverlap", "20",
        "--overlapper", "native",
    ])
    out2 = tmp_path / "resumed.fasta"
    # first pass with --resume writes chunks; second pass resumes (all
    # chunks complete -> just assembles)
    cli.main_correct([
        "--in", str(reads_fa), "--out", str(out2),
        "--windowSize", "200", "--windowOverlap", "20",
        "--overlapper", "native", "--resume",
    ])
    cli.main_correct([
        "--in", str(reads_fa), "--out", str(out2),
        "--windowSize", "200", "--windowOverlap", "20",
        "--overlapper", "native", "--resume",
    ])
    assert open(out1).read() == open(out2).read()


def test_cli_multihost_shards_match_single(small_dataset, tmp_path):
    """Two-host sharded run merged == single-host run."""
    tmp, genome, reads, draft, reads_fa, asm_fa = small_dataset
    single = tmp_path / "single.fasta"
    cli.main_correct([
        "--in", str(reads_fa), "--out", str(single),
        "--windowSize", "200", "--windowOverlap", "20",
        "--overlapper", "native",
    ])
    merged = tmp_path / "merged.fasta"
    for idx in (0, 1):
        cli.main_correct([
            "--in", str(reads_fa), "--out", str(merged),
            "--windowSize", "200", "--windowOverlap", "20",
            "--overlapper", "native",
            "--process-index", str(idx), "--process-count", "2",
        ])
    cli.main_merge_shards([
        "--out", str(merged), "--process-count", "2",
    ])
    assert open(single).read() == open(merged).read()


def test_cli_multihost_resume_stats(small_dataset, tmp_path, capsys):
    """Multi-host shards are first-class: --resume and --stats compose
    with sharding, and the merged output still matches single-host."""
    tmp, genome, reads, draft, reads_fa, asm_fa = small_dataset
    single = tmp_path / "single.fasta"
    cli.main_correct([
        "--in", str(reads_fa), "--out", str(single),
        "--windowSize", "200", "--windowOverlap", "20",
        "--overlapper", "native",
    ])
    merged = tmp_path / "m.fasta"
    for idx in (0, 1):
        for _ in range(2):  # second pass resumes completed chunks
            cli.main_correct([
                "--in", str(reads_fa), "--out", str(merged),
                "--windowSize", "200", "--windowOverlap", "20",
                "--overlapper", "native", "--resume", "--stats",
                "--process-index", str(idx), "--process-count", "2",
            ])
    cli.main_merge_shards(["--out", str(merged), "--process-count", "2"])
    assert open(single).read() == open(merged).read()


def test_cli_resume_config_mismatch_aborts(small_dataset, tmp_path):
    from consent_jax.pipeline.checkpoint import ResumeMismatch

    tmp, genome, reads, draft, reads_fa, asm_fa = small_dataset
    out = tmp_path / "guard.fasta"
    cli.main_correct([
        "--in", str(reads_fa), "--out", str(out),
        "--windowSize", "200", "--windowOverlap", "20",
        "--overlapper", "native", "--resume",
    ])
    with pytest.raises(ResumeMismatch):
        cli.main_correct([
            "--in", str(reads_fa), "--out", str(out),
            "--windowSize", "200", "--windowOverlap", "40",  # changed
            "--overlapper", "native", "--resume",
        ])


def test_cli_version_flag(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main_correct(["--version"])
    assert e.value.code == 0
    assert "consent-jax" in capsys.readouterr().out


def test_cli_chunk_quarantine_and_repair(small_dataset, tmp_path,
                                         monkeypatch, capsys):
    """Fault injection: a chunk that fails every retry is quarantined
    (run completes, failure isolated, warning printed); a --resume
    rerun retries exactly the quarantined chunk and restores the
    byte-identical full output (SURVEY §5 shard-level retry)."""
    tmp, genome, reads, draft, reads_fa, asm_fa = small_dataset
    from consent_jax.pipeline import engine as engine_mod

    flags = [
        "--in", str(reads_fa), "--windowSize", "200",
        "--windowOverlap", "20", "--overlapper", "native",
    ]
    out1 = tmp_path / "fresh.fasta"
    cli.main_correct(flags + ["--out", str(out1)])
    fresh = open(out1).read()
    assert fresh

    monkeypatch.setattr(cli, "CHUNK_PILES", 4)
    out2 = tmp_path / "quar.fasta"
    real = engine_mod.process_piles
    calls = {"n": 0}

    def flaky(piles, index, cfg, **kw):
        calls["n"] += 1
        if calls["n"] in (2, 3):  # chunk 1: initial attempt + 1 retry
            raise RuntimeError("injected chunk failure")
        yield from real(piles, index, cfg, **kw)

    monkeypatch.setattr(engine_mod, "process_piles", flaky)
    rc = cli.main_correct(flags + ["--out", str(out2), "--resume"])
    # the run completed despite the failing chunk, but the output is
    # missing reads — the exit code must make that machine-detectable
    assert rc != 0
    err = capsys.readouterr().err
    assert "quarantined" in err
    partial = open(out2).read()
    assert partial and partial != fresh  # chunk 1's reads are missing
    assert len(partial) < len(fresh)

    # repair: rerun with --resume and the fault gone
    monkeypatch.setattr(engine_mod, "process_piles", real)
    rc = cli.main_correct(flags + ["--out", str(out2), "--resume"])
    assert rc == 0
    assert open(out2).read() == fresh


# ---------------------------------------------------------------------------
# minimap2 contract (reference: CONSENT-correct:185,187; CONSENT-polish:189)
# minimap2 itself is not installed here; a fake binary on PATH records
# the exact argv and emits a canned PAF, covering _run_minimap2 and
# both post-minimap chains (group-by-query after correct; sort-by-
# target + reformat after polish) against the --paf path.


def _fake_minimap2(tmp_path, canned_paf):
    """Drop an executable `minimap2` into tmp_path that records its
    argv and cats the canned PAF to stdout."""
    args_file = tmp_path / "minimap2.argv"
    script = tmp_path / "minimap2"
    script.write_text(
        "#!/bin/sh\n"
        f'printf \'%s\\n\' "$@" > "{args_file}"\n'
        f'cat "{canned_paf}"\n'
    )
    script.chmod(0o755)
    return args_file


def test_minimap2_contract_correct(small_dataset, tmp_path, monkeypatch):
    tmp, genome, reads, draft, reads_fa, asm_fa = small_dataset
    from consent_jax.io import paf as paf_mod
    from consent_jax.io.fasta import ReadIndex
    from consent_jax.overlap import minimizer as mz

    index = ReadIndex.from_file(str(reads_fa))
    named = [(n, index[n]) for n in index.names()]
    piles = list(mz.all_vs_all_piles(named, mz.OverlapParams(), 150))
    canned = tmp_path / "canned.paf"
    paf_mod.write_piles_paf(piles, str(canned))
    # scatter the lines so group_paf_by_query has real work to do
    lines = canned.read_text().splitlines()
    canned.write_text("\n".join(lines[1::2] + lines[0::2]) + "\n")

    args_file = _fake_minimap2(tmp_path, canned)
    monkeypatch.setenv(
        "PATH", f"{tmp_path}:{__import__('os').environ['PATH']}"
    )

    flags = ["--windowSize", "200", "--windowOverlap", "20",
             "--nproc", "3"]
    out_mm = tmp_path / "mm.fasta"
    rc = cli.main_correct(
        ["--in", str(reads_fa), "--out", str(out_mm),
         "--overlapper", "minimap2"] + flags
    )
    assert rc == 0
    # the reference's exact PB argument string (CONSENT-correct:187)
    argv = args_file.read_text().split("\n")
    argv = [a for a in argv if a]
    assert argv == [
        "--dual=yes", "-PD", "--no-long-join", "-w5", "-g1000",
        "-m30", "-n1", "-t", "3", "-I", "1G",
        str(reads_fa), str(reads_fa),
    ]

    # ONT type switches to the long-join-suppressed k15 invocation
    # (CONSENT-correct:185)
    out_ont = tmp_path / "ont.fasta"
    cli.main_correct(
        ["--in", str(reads_fa), "--out", str(out_ont),
         "--overlapper", "minimap2", "--type", "ONT"] + flags
    )
    argv = [a for a in args_file.read_text().split("\n") if a]
    assert argv[:12] == [
        "-k15", "-w5", "-m100", "-g10000", "-r2000",
        "--max-chain-skip", "25", "--dual=yes", "-PD",
        "--no-long-join", "-t", "3",
    ]

    # equality with the --paf path fed the same (grouped) PAF
    grouped = tmp_path / "grouped.paf"
    paf_mod.group_paf_by_query(str(canned), str(grouped))
    out_paf = tmp_path / "paf.fasta"
    rc = cli.main_correct(
        ["--in", str(reads_fa), "--out", str(out_paf),
         "--paf", str(grouped)] + flags
    )
    assert rc == 0
    assert out_mm.read_text() == out_paf.read_text()
    assert out_mm.read_text()  # non-trivial output


def test_minimap2_contract_polish(small_dataset, tmp_path, monkeypatch):
    tmp, genome, reads, draft, reads_fa, asm_fa = small_dataset
    from consent_jax.io import paf as paf_mod
    from consent_jax.io.fasta import ReadIndex
    from consent_jax.overlap import minimizer as mz

    contigs = ReadIndex.from_file(str(asm_fa))
    rd = ReadIndex.from_file(str(reads_fa))
    piles = list(
        mz.map_to_targets_piles(
            [(n, contigs[n]) for n in contigs.names()],
            [(n, rd[n]) for n in rd.names()],
            mz.OverlapParams(), 20000,
        )
    )
    # fabricate minimap2's raw output: reads as query, contig as
    # target (the polish chain sorts by target then reformats)
    canned = tmp_path / "canned.paf"
    paf_mod.write_piles_paf(piles, str(canned), swap=True)

    args_file = _fake_minimap2(tmp_path, canned)
    monkeypatch.setenv(
        "PATH", f"{tmp_path}:{__import__('os').environ['PATH']}"
    )
    flags = ["--windowSize", "200", "--windowOverlap", "20",
             "--nproc", "2"]
    out_mm = tmp_path / "mm.fasta"
    rc = cli.main_polish(
        ["--contigs", str(asm_fa), "--reads", str(reads_fa),
         "--out", str(out_mm), "--overlapper", "minimap2"] + flags
    )
    assert rc == 0
    argv = [a for a in args_file.read_text().split("\n") if a]
    # polish uses the PB invocation with contigs as target, reads as
    # query (CONSENT-polish:189)
    assert argv == [
        "--dual=yes", "-PD", "--no-long-join", "-w5", "-g1000",
        "-m30", "-n1", "-t", "2", "-I", "1G",
        str(asm_fa), str(reads_fa),
    ]

    srt = tmp_path / "srt.paf"
    ref = tmp_path / "ref.paf"
    paf_mod.sort_by_target(str(canned), str(srt))
    paf_mod.reformat_file(str(srt), str(ref))
    out_paf = tmp_path / "paf.fasta"
    rc = cli.main_polish(
        ["--contigs", str(asm_fa), "--reads", str(reads_fa),
         "--out", str(out_paf), "--paf", str(ref)] + flags
    )
    assert rc == 0
    assert out_mm.read_text() == out_paf.read_text()
    assert out_mm.read_text()
