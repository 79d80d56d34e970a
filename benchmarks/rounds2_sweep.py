#!/usr/bin/env python
"""Throughput side of the rounds=2 operating-point decision
(VERDICT r4 ask #3): sweep the fused two-round consensus executable
over batch size B and warm-round depth on the real chip, chain-slope
timed like bench.py.  benchmarks/warm_matrix.py measures the accuracy
side; PARITY.md records the combined decision table.

Usage: python benchmarks/rounds2_sweep.py
"""

import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BASELINE_WINDOWS_PER_S = 620.0


def main():
    from consent_jax.utils.jaxcache import enable
    enable()
    import jax
    import jax.numpy as jnp

    from consent_jax.ops import consensus as cons_ops
    from consent_jax.ops.align import Scoring

    S, W = 16, 512
    scoring = Scoring(max_hgap=16, band=128)
    rng = np.random.default_rng(0)

    def inputs(B):
        tpl = rng.integers(0, 4, (B, W)).astype(np.uint8)
        frags = np.zeros((B, S, W), dtype=np.uint8)
        frag_len = np.zeros((B, S), dtype=np.int32)
        for b in range(B):
            for s in range(S):
                L = W - int(rng.integers(0, 40))
                f = tpl[b, :L].copy()
                pos = rng.integers(0, L, L // 10)
                f[pos] = (f[pos] + 1 + rng.integers(0, 3, L // 10)) % 4
                frags[b, s, :L] = f
                frag_len[b, s] = L
        return (jnp.asarray(frags), jnp.asarray(frag_len),
                jnp.asarray(tpl), jnp.asarray(np.full(B, W, np.int32)))

    def slope(B, warm):
        frags_d, fl_d, tpl_d, tl_d = inputs(B)

        @functools.partial(jax.jit, static_argnames=("rounds",))
        def fused(fr, rounds):
            v, _ = cons_ops.consensus_votes_rounds(
                fr, fl_d, tpl_d, tl_d, S=S, rounds=rounds,
                min_column_support=2, scoring=scoring, warm_frac=warm,
            )
            return v

        def chain(k, fr):
            out = None
            for _ in range(k):
                out = fused(fr, 2)
                fr = (fr + out.col_base[:, None, :].astype(jnp.uint8)) % 4
            return jax.device_get(out.col_base).sum()

        chain(1, frags_d)
        chain(4, frags_d)
        per = []
        for _ in range(5):
            t0 = time.perf_counter()
            chain(2, frags_d)
            ts = time.perf_counter() - t0
            t0 = time.perf_counter()
            chain(10, frags_d)
            tl = time.perf_counter() - t0
            per.append(max(1e-9, (tl - ts) / 8))
        ms = float(np.median(per)) * 1e3
        return {
            "B": B, "warm_frac": warm,
            "rounds2_ms_per_call": round(ms, 3),
            "rounds2_windows_per_s": round(B / ms * 1e3, 1),
            "vs_baseline": round(B / ms * 1e3 / BASELINE_WINDOWS_PER_S, 3),
        }

    rows = []
    for B, warm in [(64, 1.0), (64, 0.5), (64, 0.25),
                    (128, 0.5), (128, 0.25)]:
        r = slope(B, warm)
        rows.append(r)
        print(json.dumps(r), file=sys.stderr, flush=True)
    print(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
