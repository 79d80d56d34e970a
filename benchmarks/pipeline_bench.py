#!/usr/bin/env python
"""End-to-end correction throughput on the current backend.

Simulates a CLR-like read set, runs the full correction pipeline
(native overlapper -> windows -> device consensus -> DBG -> stitch ->
trim), and reports reads/s, windows/s, and per-stage time."""

import sys, time
from consent_jax.utils.jaxcache import enable
enable()

import numpy as np
from consent_jax.config import correct_preset
from consent_jax.io.fasta import ReadIndex
from consent_jax.pipeline import engine
from consent_jax.testing import metrics, simulate
from consent_jax.overlap import minimizer as mz

def main(genome_len=60000, coverage=12.0, read_len=3000):
    t0 = time.perf_counter()
    genome, reads = simulate.simulate(
        genome_len=genome_len, coverage=coverage, read_len=read_len,
        error_rate=0.10, seed=1,
    )
    print(f"simulated {len(reads)} reads in {time.perf_counter()-t0:.1f}s",
          file=sys.stderr)

    cfg = correct_preset()
    index = ReadIndex()
    for r in reads:
        index.add(r.name, r.codes)

    t0 = time.perf_counter()
    piles = list(mz.all_vs_all_piles(
        [(r.name, r.codes) for r in reads], mz.OverlapParams(),
        cfg.max_support))
    t_overlap = time.perf_counter() - t0
    print(f"overlaps: {len(piles)} piles in {t_overlap:.1f}s", file=sys.stderr)

    t0 = time.perf_counter()
    n_windows = 0
    results = []
    for name, codes, solid in engine.process_piles(iter(piles), index, cfg):
        results.append((name, codes))
    t_pipe = time.perf_counter() - t0

    total_bases = sum(len(r.codes) for r in reads)
    n_windows = total_bases // (cfg.window_size - cfg.window_overlap)
    n_out = sum(1 for _, c in results if len(c))
    by_name = {r.name: r for r in reads}
    ids = []
    for name, codes in results[:50]:
        if not len(codes):
            continue
        r = by_name[name]
        truth = genome[r.g_beg:r.g_end]
        if r.reverse:
            from consent_jax.io import seqs as s_
            truth = s_.revcomp(truth)
        ids.append(metrics.identity(codes, truth))
    print(f"pipeline: {t_pipe:.1f}s | {len(piles)/t_pipe:.1f} reads/s | "
          f"~{n_windows/t_pipe:.0f} windows/s | {n_out}/{len(piles)} kept | "
          f"mean identity {np.mean(ids):.4f}", file=sys.stderr)
    from consent_jax.utils.observe import GLOBAL_STATS
    GLOBAL_STATS.report()

if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--genome", type=int, default=60000)
    p.add_argument("--coverage", type=float, default=12.0)
    args = p.parse_args()
    main(args.genome, args.coverage)
