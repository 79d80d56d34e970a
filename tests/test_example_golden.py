"""Golden-style integration test on the reference's bundled example
assembly (/root/reference/example/rawAssembly.fasta, the only example
file present in the snapshot — the read set is LFS-missing, so reads
are simulated from the contigs themselves)."""

import os

import numpy as np
import pytest

from consent_jax.config import polish_preset
from consent_jax.io import seqs
from consent_jax.io.fasta import ReadIndex, iter_fastx
from consent_jax.overlap import minimizer as mz
from consent_jax.pipeline import engine
from consent_jax.pipeline.stitch import host_batch_align
from consent_jax.testing import metrics, simulate

EXAMPLE = "/root/reference/example/rawAssembly.fasta"


@pytest.mark.skipif(not os.path.exists(EXAMPLE), reason="example absent")
def test_polish_reference_example_contig():
    # one real contig from the bundled assembly
    name, seq = next(iter_fastx(EXAMPLE))
    contig = seqs.encode(seq)[:4000]
    rng = np.random.default_rng(0)

    # corrupt the contig (draft) and simulate reads from the true one
    draft, _ = simulate.mutate(contig, rng, 0.02)
    reads = []
    for i in range(40):
        L = int(rng.integers(600, 1200))
        g0 = int(rng.integers(0, len(contig) - L))
        noisy, _ = simulate.mutate(contig[g0 : g0 + L], rng, 0.08)
        if rng.random() < 0.5:
            noisy = seqs.revcomp(noisy)
        reads.append((f"read{i}", noisy))

    cfg = polish_preset(window_size=200, window_overlap=20,
                        consensus_rounds=1)
    index = ReadIndex()
    index.add("contig", draft)
    for n, c in reads:
        index.add(n, c)

    piles = list(
        mz.map_to_targets_piles([("contig", draft)], reads,
                                mz.OverlapParams(), cfg.max_support)
    )
    results = list(
        engine.process_piles(iter(piles), index, cfg,
                             batch_align=host_batch_align)
    )
    (rname, codes, solid) = results[0]
    before = metrics.identity(draft, contig)
    after = metrics.identity(codes, contig)
    print(f"example contig: draft {before:.4f} -> polished {after:.4f}")
    assert after > before
    assert after > 0.99
