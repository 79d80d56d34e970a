"""End-to-end regression gate on a GPU.

A small-scale (400-read) native-overlapper end-to-end run — the exact
production composition: minimizer overlap piles -> device consensus
(fused warm rounds) -> native host post -> interleaved stitch — gated
on corrected identity.

Run on the card with:
    CONSENT_TESTS_ON_DEVICE=1 python -m pytest -m gpu tests/
(conftest.py then keeps the real backend instead of forcing the CPU).
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_native_overlap_e2e_identity():
    from consent_jax.config import correct_preset
    from consent_jax.io import seqs
    from consent_jax.io.fasta import ReadIndex
    from consent_jax.overlap import minimizer as mz
    from consent_jax.pipeline import engine
    from consent_jax.testing import metrics, simulate
    from consent_jax.utils.jaxcache import enable as enable_cache

    enable_cache()
    genome, reads = simulate.simulate(
        genome_len=160_000, coverage=10.0, read_len=4000,
        error_rate=0.10, seed=7,
    )
    assert len(reads) >= 350
    cfg = correct_preset()
    index = ReadIndex()
    for r in reads:
        index.add(r.name, r.codes)
    named = [(r.name, r.codes) for r in reads]
    piles = list(
        mz.all_vs_all_piles(named, mz.OverlapParams(), cfg.max_support)
    )

    results = list(engine.process_piles(iter(piles), index, cfg))

    by = {r.name: r for r in reads}
    ids = []
    n_windows = 0
    for name, codes, solid in results:
        if not len(codes):
            continue
        r = by[name]
        t = genome[r.g_beg : r.g_end]
        if r.reverse:
            t = seqs.revcomp(t)
        ids.append(metrics.identity(codes, t))
    ident = float(np.mean(ids))
    # 1 pp under the corrected identity measured at full scale
    # (0.9865): a real regression fails, noise does not
    assert ident >= 0.977, f"e2e corrected identity regressed: {ident:.4f}"
    assert len(ids) >= 0.95 * len(reads)
