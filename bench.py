#!/usr/bin/env python
"""Benchmark of the device hot path on one NVIDIA GPU.

Measurements, all warm and timed on the host clock around work that
ends in block_until_ready (median of 5 runs):

  * aligner: the Hopper posterior-alignment kernel (ops/gpu_align.py)
    vs XLA's compile of ops/align.py posterior_summary at the
    production widths, each after a bit-for-bit check —
      consensus: N=4096 lanes, Lq=512, Lr=640, band 128, gap cap 16,
      stitch:    N=1024 lanes, Lq=Lr=640, exact;
  * consensus: the engine's production dispatch for the S=16 bucket
    (B=256 windows x 16 slots, both refinement rounds fused, warm
    rounds at the default depth) in windows/s;
  * --e2e: chip_smoke.py's correction phase (main_correct on the
    simulated PB CLR example) with the kernel and with the XLA aligner
    in turns: one untimed warm-up leg of each fills the persistent
    compile cache, then E2E_PAIRS alternating pairs (XLA, kernel, kernel,
    XLA, ...), each leg from a cleared in-memory jit cache.  Every leg
    reports its compile-cache hits and misses and its backend compile
    seconds, so a warm leg shows that it compiled nothing.

The device (platform, kind, count) and the card's name and power limit
are printed first; the last line is one JSON object.  Exits non-zero
without a GPU.

Usage: python bench.py [--e2e] [--genome-mb 3.35]
"""

import argparse
import collections
import json
import sys
import tempfile
import time

import chip_smoke

REPS = 5
E2E_PAIRS = 3


def _median_ms(fn, args, reps):
    t, runs = chip_smoke._timed(fn, args, reps)
    return t * 1e3, [x * 1e3 for x in runs]


def consensus_windows_per_s(reps: int) -> dict:
    import jax
    import jax.numpy as jnp

    from consent_jax.config import correct_preset
    from consent_jax.ops import consensus as cons_ops
    from consent_jax.ops.align import Scoring

    cfg = correct_preset()
    B, S = 256, 16
    q, ql, tpl, tl, d0 = chip_smoke.window_batch(B, S, seed=1)
    args = (jnp.asarray(q.reshape(B, S, -1)), jnp.asarray(ql.reshape(B, S)),
            jnp.asarray(tpl), jnp.asarray(tl), jnp.asarray(d0.reshape(B, S)))
    sc = Scoring(max_hgap=cfg.consensus_max_hgap, band=cfg.consensus_band)

    @jax.jit
    def fused(frags, frag_len, tpl, tpl_len, frag_d0):
        return cons_ops.consensus_votes_rounds(
            frags, frag_len, tpl, tpl_len, S=S, rounds=cfg.consensus_rounds,
            min_column_support=cfg.min_column_support, scoring=sc,
            frag_d0=frag_d0, warm_frac=cfg.warm_frac)

    ms, runs = _median_ms(fused, args, reps)
    return {"B": B, "S": S, "rounds": cfg.consensus_rounds,
            "warm_frac": cfg.warm_frac, "ms_per_call": ms,
            "runs_ms": runs, "windows_per_s": B / (ms / 1e3)}


class CompileLog:
    """Counts JAX's persistent compile-cache events and backend compile
    seconds between take() calls."""

    def __init__(self):
        import jax

        self.counts = collections.Counter()
        self.compile_s = 0.0
        jax.monitoring.register_event_listener(self._event)
        jax.monitoring.register_event_duration_secs_listener(self._duration)

    def _event(self, event, **_):
        if event.startswith("/jax/compilation_cache/"):
            self.counts[event.rsplit("/", 1)[1]] += 1

    def _duration(self, event, duration_secs, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.counts["backend_compiles"] += 1
            self.compile_s += duration_secs

    def take(self) -> dict:
        out = {"cache_hits": self.counts["cache_hits"],
               "cache_misses": self.counts["cache_misses"],
               "backend_compiles": self.counts["backend_compiles"],
               "backend_compile_s": self.compile_s}
        self.counts.clear()
        self.compile_s = 0.0
        return out


def e2e_order(pairs: int) -> list:
    """(aligner, warm-up?) legs: one warm-up of each aligner, then
    `pairs` alternating pairs, XLA first in every other pair."""
    legs = [("xla", True), ("kernel", True)]
    for k in range(pairs):
        first, second = ("xla", "kernel") if k % 2 == 0 else ("kernel", "xla")
        legs += [(first, False), (second, False)]
    return legs


def e2e_legs(genome_mb: float, pairs: int) -> dict:
    """The smoke's correction wall with the kernel and with XLA's
    posterior_summary as the aligner, one leg per entry of e2e_order."""
    import jax
    import numpy as np

    from consent_jax.ops import align as align_ops

    kernel_summary = align_ops.summary

    def xla_summary(q, q_len, r, r_len, sc=align_ops.Scoring(), d0=None):
        return align_ops.posterior_summary(q, q_len, r, r_len, sc, d0=d0)

    impls = {"kernel": kernel_summary, "xla": xla_summary}
    compiles = CompileLog()
    legs = []
    with tempfile.TemporaryDirectory() as workdir:
        genome, reads, reads_fa = chip_smoke.simulate_dataset(genome_mb,
                                                              workdir)
        for name, warmup in e2e_order(pairs):
            align_ops.summary = impls[name]
            jax.clear_caches()
            compiles.take()
            res = chip_smoke.phase_correct(genome, reads, reads_fa, workdir)
            leg = {"aligner": name, "warmup": warmup,
                   "wall_s": res["wall_s"], "windows": res["windows"],
                   "identity": res["corrected_identity"],
                   "compiles": compiles.take(),
                   "stages_s": res["stages"]["seconds"]}
            print(f"[e2e] {name}{' (warm-up)' if warmup else ''}: wall "
                  f"{leg['wall_s']} s, compiles {leg['compiles']}",
                  flush=True)
            legs.append(leg)
    align_ops.summary = kernel_summary
    walls = {n: [g["wall_s"] for g in legs
                 if g["aligner"] == n and not g["warmup"]]
             for n in impls}
    summary = {n: {"walls_s": w, "median_s": float(np.median(w)),
                   "min_s": min(w), "max_s": max(w)}
               for n, w in walls.items()}
    print(f"[e2e] timed legs: {json.dumps(summary)}", flush=True)
    return {"genome_mb": genome_mb, "pairs": pairs, "legs": legs,
            "summary": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--genome-mb", type=float, default=chip_smoke.GENOME_MB)
    args = ap.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        print("bench: no GPU", file=sys.stderr)
        return 2
    from consent_jax.utils.jaxcache import enable

    enable()
    info = chip_smoke.phase_devices()
    report = {"device": info, "cards": chip_smoke.card_names()}
    t0 = time.perf_counter()
    report["aligner"] = chip_smoke.phase_kernel(reps=REPS, oracle_lanes=0)
    report["consensus"] = consensus_windows_per_s(REPS)
    print(f"consensus dispatch B=256 S=16: "
          f"{report['consensus']['ms_per_call']:.3f} ms per call, "
          f"{report['consensus']['windows_per_s']:.0f} windows/s",
          flush=True)
    if args.e2e:
        report["e2e"] = e2e_legs(args.genome_mb, E2E_PAIRS)
    report["bench_wall_s"] = time.perf_counter() - t0
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
