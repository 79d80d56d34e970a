"""Small evaluation / comparison utilities (consent-eval)."""

from __future__ import annotations

import argparse
import sys

import numpy as np

from consent_jax.io import seqs
from consent_jax.io.fasta import iter_fastx
from consent_jax.testing import metrics


def main_eval(argv=None) -> int:
    """Compare two FASTA files record-by-record (names matched):
    reports per-record and mean identity — the framework's stand-in for
    the reference's external ELECTOR-style evaluation."""
    p = argparse.ArgumentParser(prog="consent-eval")
    p.add_argument("--test", required=True, help="corrected/polished FASTA")
    p.add_argument("--truth", required=True, help="ground truth FASTA")
    p.add_argument("--band", type=int, default=512)
    p.add_argument("--per-record", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="per-error-type (sub/ins/del) rates, "
                        "ELECTOR-style")
    p.add_argument("--trimmed", action="store_true",
                   help="score semi-globally: truth overhangs at read "
                        "ends are free (use when the corrector trims)")
    args = p.parse_args(argv)

    truth = {n: seqs.encode(s) for n, s in iter_fastx(args.truth)}
    ids = []
    agg = {"n_sub": 0, "n_ins": 0, "n_del": 0, "n_match": 0}
    n_missing = 0
    for name, s in iter_fastx(args.test):
        if name not in truth:
            n_missing += 1
            continue
        codes = seqs.encode(s)
        if args.profile or args.trimmed:
            prof = metrics.error_profile(
                codes, truth[name], args.band,
                free_truth_ends=args.trimmed,
            )
            for k in agg:
                agg[k] += prof[k]
            ident = prof["identity"]
        else:
            ident = metrics.identity(codes, truth[name], args.band)
        ids.append(ident)
        if args.per_record:
            print(f"{name}\t{ident:.5f}")
    mean = float(np.mean(ids)) if ids else 0.0
    msg = (
        f"records={len(ids)} unmatched={n_missing} "
        f"mean_identity={mean:.5f} "
        f"q{int(-10 * np.log10(max(1e-9, 1 - mean)))}"
    )
    if args.profile or args.trimmed:
        cols = max(1, sum(agg.values()))
        msg += (
            f" sub_rate={agg['n_sub']/cols:.5f}"
            f" ins_rate={agg['n_ins']/cols:.5f}"
            f" del_rate={agg['n_del']/cols:.5f}"
        )
    print(msg, file=sys.stderr)
    return 0
