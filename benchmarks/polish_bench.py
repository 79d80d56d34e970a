#!/usr/bin/env python
"""End-to-end POLISHING benchmark on the bundled example assembly.

The reference polishes its bundled 3.35 Mb / 86-contig assembly
(example/rawAssembly.fasta) in ~15 s on 4 CPU cores including minimap2
(reference README.md:63).  The example reads are LFS-missing from the
snapshot, so this benchmark simulates a 10x read set over the bundled
contigs (10% CLR errors), mutates the contigs into a 1%-error draft,
and runs the FULL polishing path wall-to-wall:

  * overlap  — native read->contig mapping (map_to_targets_piles,
               the role of minimap2 + sort + reformat)
  * pipeline — windows -> device consensus -> k-mer/DBG -> stitch
               (consent polish preset: no trimming, minSupport=1)

Reports wall seconds, Mb/s, the polished-vs-draft identity gate, and
the per-stage breakdown.  Usage:
  python benchmarks/polish_bench.py [--out polish_bench.json]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ASSEMBLY = "/root/reference/example/rawAssembly.fasta"
REF_WALL_S = 15.0          # reference envelope (README.md:63, 4 cores)


def simulate_reads(truth_contigs, coverage, read_len, error_rate, seed):
    from consent_jax.testing.simulate import mutate

    rng = np.random.default_rng(seed)
    reads = []
    ridx = 0
    for name, codes in truth_contigs:
        n = max(1, int(coverage * len(codes) / read_len))
        for _ in range(n):
            L = min(len(codes), int(read_len * (0.7 + 0.6 * rng.random())))
            g0 = int(rng.integers(0, len(codes) - L + 1))
            noisy, _ = mutate(codes[g0 : g0 + L], rng, error_rate)
            reads.append((f"r{ridx}", noisy))
            ridx += 1
    return reads


def main(coverage, read_len, error_rate, draft_err, out_path):
    from consent_jax.utils.jaxcache import enable
    enable()

    from consent_jax.config import polish_preset
    from consent_jax.io import seqs
    from consent_jax.io.fasta import ReadIndex, iter_fastx
    from consent_jax.overlap import minimizer as mz
    from consent_jax.pipeline import engine
    from consent_jax.testing import metrics
    from consent_jax.testing.simulate import mutate
    from consent_jax.utils.observe import GLOBAL_STATS

    cfg = polish_preset()
    rng = np.random.default_rng(3)

    truth = [
        (name, seqs.encode(seq)) for name, seq in iter_fastx(ASSEMBLY)
    ]
    total_mb = sum(len(c) for _, c in truth) / 1e6
    draft = [(n, mutate(c, rng, draft_err)[0]) for n, c in truth]
    t0 = time.perf_counter()
    reads = simulate_reads(truth, coverage, read_len, error_rate, seed=3)
    t_sim = time.perf_counter() - t0
    read_mb = sum(len(c) for _, c in reads) / 1e6
    print(
        f"[sim] {len(truth)} contigs ({total_mb:.2f} Mb), "
        f"{len(reads)} reads ({read_mb:.1f} Mb) in {t_sim:.1f}s "
        f"(excluded)",
        file=sys.stderr,
    )

    index = ReadIndex()
    for n, c in draft:
        index.add(n, c)
    for n, c in reads:
        index.add(n, c)

    # ---- overlap stage
    t0 = time.perf_counter()
    piles = list(
        mz.map_to_targets_piles(draft, reads, mz.OverlapParams(),
                                cfg.max_support)
    )
    t_overlap = time.perf_counter() - t0
    print(f"[overlap] {len(piles)} piles ({t_overlap:.1f}s)",
          file=sys.stderr)

    # ---- warmup (compile executables; excluded like e2e_bench).
    # A FULL pass: deep-pile bucket/tail shapes appear throughout the
    # contig set, and any shape missed here would bill a compile to
    # the timed region.
    tw = time.perf_counter()
    for _ in engine.process_piles(iter(piles), index, cfg):
        pass
    print(f"[warmup] {len(piles)} piles "
          f"({time.perf_counter() - tw:.1f}s, excluded)", file=sys.stderr)
    GLOBAL_STATS.seconds.clear()
    GLOBAL_STATS.counts.clear()

    # ---- polish pipeline
    truth_by = dict(truth)
    draft_by = dict(draft)
    t0 = time.perf_counter()
    results = list(engine.process_piles(iter(piles), index, cfg))
    t_pipe = time.perf_counter() - t0
    stages = GLOBAL_STATS.snapshot()
    n_windows = stages["counts"].get("windows.total", 0)

    draft_ids, pol_ids = [], []
    for name, codes, solid in results:
        t = truth_by[name]
        if len(codes) == 0:
            continue
        pol_ids.append(metrics.identity(codes, t))
        draft_ids.append(metrics.identity(draft_by[name], t))

    report = {
        "workload": {
            "assembly": ASSEMBLY,
            "assembly_mb": round(total_mb, 2),
            "n_contigs": len(truth),
            "read_bases_mb": round(read_mb, 1),
            "coverage": coverage,
            "draft_error": draft_err,
            "n_windows": int(n_windows),
        },
        "pipeline_wall_s": round(t_pipe, 2),
        "overlap_wall_s": round(t_overlap, 2),
        "total_wall_s": round(t_pipe + t_overlap, 2),
        "mb_per_s": round(total_mb / (t_pipe + t_overlap), 3),
        "windows_per_s": round(n_windows / t_pipe, 1),
        "vs_baseline_wall": round(
            REF_WALL_S / (t_pipe + t_overlap), 3
        ),
        "accuracy": {
            "draft_identity": round(float(np.mean(draft_ids)), 4),
            "polished_identity": round(float(np.mean(pol_ids)), 4),
            "n_polished": len(pol_ids),
        },
        "stages": stages,
        "reference_envelope": "~15 s / 4 cores incl. minimap2 for the "
                              "same assembly (README.md:63)",
        "host_cores": os.cpu_count(),
    }
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: report[k] for k in (
        "pipeline_wall_s", "overlap_wall_s", "total_wall_s",
        "vs_baseline_wall")}))
    ok = report["accuracy"]["polished_identity"] > max(
        0.99, report["accuracy"]["draft_identity"]
    )
    print(f"accuracy gate (polished > draft and > 0.99): "
          f"{'PASS' if ok else 'FAIL'}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--coverage", type=float, default=10.0)
    p.add_argument("--read-len", type=int, default=4000)
    p.add_argument("--error-rate", type=float, default=0.10)
    p.add_argument("--draft-err", type=float, default=0.01)
    p.add_argument("--out", default="polish_bench.json")
    a = p.parse_args()
    sys.exit(main(a.coverage, a.read_len, a.error_rate, a.draft_err,
                  a.out))
