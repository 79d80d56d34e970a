#!/usr/bin/env python
"""Warm-round depth decision matrix.

Measures read-level corrected identity at the reference operating
point (windowSize=500, windowOverlap=50 — CONSENT-correct:45,50) for
`consensus_rounds` x `warm_frac` alternatives, on both error profiles
(PB 10% CLR, ONT 12% indel-heavy).  The warm rounds (all but the last)
realign only the top ceil(S*warm_frac) fragment slots — this script
provides the measured accuracy side of the throughput/accuracy
frontier recorded in PARITY.md; bench.py provides the throughput side.

Runs on CPU by default (accuracy is backend-independent — the suite
asserts 1-vs-8-device and GPU-kernel-vs-XLA bit equality elsewhere);
pass --device to keep JAX's default backend (the GPU where there is
one).

Usage: python benchmarks/warm_matrix.py [--n-piles 24] [--device]
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_point(error_rate, frac_sub, frac_ins, n_piles, rounds, warm):
    from consent_jax.utils.jaxcache import enable
    enable()
    from consent_jax.config import correct_preset
    from consent_jax.io import seqs
    from consent_jax.io.fasta import ReadIndex
    from consent_jax.pipeline import engine
    from consent_jax.pipeline.stitch import host_batch_align
    from consent_jax.testing import metrics, simulate

    genome, reads = simulate.simulate(
        genome_len=6000, coverage=14.0, read_len=2000,
        error_rate=error_rate, seed=42, frac_sub=frac_sub,
        frac_ins=frac_ins,
    )
    cfg = correct_preset(consensus_rounds=rounds, warm_frac=warm)
    index = ReadIndex()
    for r in reads:
        index.add(r.name, r.codes)
    piles = simulate.piles_from_sim(reads, cfg.max_support)[:n_piles]
    results = list(
        engine.process_piles(iter(piles), index, cfg,
                             batch_align=host_batch_align)
    )
    by_name = {r.name: r for r in reads}
    cor_ids = []
    for (name, codes, solid) in results:
        if len(codes) == 0:
            continue
        read = by_name[name]
        truth = genome[read.g_beg:read.g_end]
        if read.reverse:
            truth = seqs.revcomp(truth)
        cor_ids.append(
            metrics.error_profile(codes, truth,
                                  free_truth_ends=True)["identity"]
        )
    return float(np.mean(cor_ids)), len(cor_ids)


def main(n_piles):
    # (2, 0.375) is omitted: at the kernel's TILE_N=256 lane padding
    # with the production B=64/S=16 batch, Sw=6 pads to the same 512
    # lanes as Sw=8 — it costs exactly warm=0.5 and can only lose
    # accuracy.  rounds=1 is characterized in config.py (-0.5/-0.9 pp).
    points = [
        (2, 1.0), (2, 0.5), (2, 0.25),
    ]
    profiles = [
        ("PB", 0.10, 1 / 3, 1 / 3),
        ("ONT", 0.12, 0.2, 0.4),
    ]
    table = []
    for rounds, warm in points:
        row = {"rounds": rounds, "warm_frac": warm}
        for name, er, fs, fi in profiles:
            cor, n = run_point(er, fs, fi, n_piles, rounds, warm)
            row[name] = round(cor, 4)
            row[f"n_{name}"] = n
            print(f"rounds={rounds} warm={warm} {name}: {cor:.4f} "
                  f"({n} reads)", file=sys.stderr, flush=True)
        table.append(row)
    print(json.dumps(table, indent=1))
    return 0


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--n-piles", type=int, default=24)
    p.add_argument("--device", action="store_true",
                   help="run on JAX's default backend instead of the CPU")
    a = p.parse_args()
    if not a.device:
        import jax

        jax.config.update("jax_platforms", "cpu")
    sys.exit(main(a.n_piles))
