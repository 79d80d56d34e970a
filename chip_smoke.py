#!/usr/bin/env python3
"""Smoke run of correction and polishing on NVIDIA GPUs.

One process drives the system's main path through the entry points a
user calls, at the size of the reference's PacBio CLR example (a 3.35 Mb
genome, 10x coverage of 4 kb reads at 10% error, `--type PB` defaults):

  1. devices: the GPU, its name and power limit, the native host library;
  2. kernel: the Hopper aligner compiled at the production widths
     (consensus N=4096 Lq=512 Lr=640 band 128 gap cap 16; stitch
     N=1024 Lq=Lr=640 exact at the stitch scoring, and Lq=Lr=1152, the
     stitch rows of --windowSize 1000), its memory analysis, bit-for-bit
     equality with ops/align.py posterior_summary, the numpy oracle on a
     few lanes, and the kernel's and XLA's time per call;
  3. correction: consent_jax.cli.main_correct with the native
     overlapper; corrected identity vs the simulated truth >= 0.977;
     then --windowSize 1000 (the stress configuration) on a 0.5 Mb
     genome under the same gate;
  4. polishing: consent_jax.cli.main_polish of a mutated draft of the
     same genome (10x), then of a 120 kb draft at 80x, whose windows
     reach the deepest fragment-slot bucket (S=152); polished identity
     above the draft's.

    python chip_smoke.py                 # one card, phases 1-4
    python chip_smoke.py --chips 4       # four cards: the data-mesh
        # correction vs one device (byte-identical FASTA) and the
        # frag-mesh votes at polishing depth (S=152) vs one device

The last line of stdout is {"ok": true, "device": {...}}; any failure
exits non-zero before it.  Without a GPU the script exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

GENOME_MB = 3.35          # the reference example's genome
COVERAGE = 10.0
READ_LEN = 4000
ERROR_RATE = 0.10
SEED = 7
IDENTITY_FLOOR = 0.977    # tests/test_e2e_regression.py gate
N_SCORED = 200            # corrected reads scored against the truth
CONTIG_LEN = 40_000       # draft contig length for polishing
N_CONTIGS_SCORED = 8
DEEP_GENOME_MB = 0.12     # deep polishing: 80x on a 120 kb draft
DEEP_COVERAGE = 80.0
WIDE_WINDOW = 1000        # the stress configuration's --windowSize
WIDE_GENOME_MB = 0.5


def log(*parts):
    print(*parts, flush=True)


def card_names() -> list:
    """nvidia-smi's name and power limit of each card (no JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def phase_devices(require_gpu: bool = True) -> dict:
    import jax

    from consent_jax import native

    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    if require_gpu:
        if dev.platform != "gpu":
            raise RuntimeError(f"no GPU: JAX runs on {dev.platform}")
        for line in card_names():
            log(f"card: {line}")
    log(f"jax {jax.__version__}; devices {info}")
    if native.get_lib() is None:
        raise RuntimeError("native host library failed to build or load")
    log("native host library: loaded")
    return info


def _kernel_shapes():
    """(name, N, Lq, Lr, scoring, d0 range, error rate, empty share) of
    the engine's consensus and stitch calls at production widths."""
    from consent_jax.ops.align import Scoring
    from consent_jax.pipeline.device_align import _SCORING as stitch

    return [
        ("consensus", 4096, 512, 640,
         Scoring(max_hgap=16, band=128), (-16, 48), 0.10, 0.2),
        ("stitch", 1024, 640, 640, stitch, (-64, 64), 0.02, 0.0),
        ("stitch-w1000", 1024, 1152, 1152, stitch, (-64, 64), 0.02, 0.0),
    ]


def _timed(fn, args, reps):
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times


def phase_kernel(shapes=None, reps: int = 5, oracle_lanes: int = 3) -> dict:
    """Compile the GPU aligner at each shape, compare it with the XLA
    scan in all six fields, and time both per call."""
    import jax
    import jax.numpy as jnp

    from consent_jax.core import npalign
    from consent_jax.ops import align as align_ops
    from consent_jax.ops import gpu_align
    from consent_jax.testing import simulate

    t0 = time.perf_counter()
    lib = gpu_align.library_path(jax.devices()[0].platform)
    gpu_align.load(jax.devices()[0].platform)
    log(f"kernel library: {os.path.basename(lib)} "
        f"({time.perf_counter() - t0:.1f} s to build and load)")
    out = {}
    for name, N, Lq, Lr, sc, d0r, err, empty in shapes or _kernel_shapes():
        q, ql, r, rl, d0 = simulate.alignment_lanes(
            N, Lq, Lr, d0_range=d0r, error_rate=err, empty_frac=empty,
            seed=N + Lq,
        )
        args = tuple(jnp.asarray(x) for x in (q, ql, r, rl, d0))
        kern = jax.jit(lambda q, ql, r, rl, d0, sc=sc:
                       gpu_align.posterior_summary(q, ql, r, rl, sc, d0=d0))
        xla = jax.jit(lambda q, ql, r, rl, d0, sc=sc:
                      align_ops.posterior_summary(q, ql, r, rl, sc, d0=d0))
        t0 = time.perf_counter()
        compiled = kern.lower(*args).compile()
        mem = compiled.memory_analysis()
        fields = ("argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "generated_code_size_in_bytes")
        log(f"[{name}] N={N} Lq={Lq} Lr={Lr} band={sc.band} "
            f"max_hgap={sc.max_hgap}: compiled in "
            f"{time.perf_counter() - t0:.1f} s; memory_analysis "
            + json.dumps({f: getattr(mem, f, None) for f in fields}))
        got = compiled(*args)
        want = xla(*args)
        for f in want._fields:
            a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
            if a.dtype != b.dtype or not np.array_equal(a, b):
                bad = int((a != b).sum()) if a.shape == b.shape else -1
                raise AssertionError(
                    f"[{name}] kernel != posterior_summary in {f} "
                    f"({bad} elements differ)")
        log(f"[{name}] bit-for-bit equal to align.posterior_summary in "
            f"all six fields ({', '.join(want._fields)}); "
            f"{int(np.asarray(want.matched).sum())} matched cells")
        if oracle_lanes and not sc.band and not sc.max_hgap:
            # exact full DP: the traceback oracle's optimum and matched
            # pairs must sit inside the summary
            for k in np.flatnonzero(ql > 0)[:oracle_lanes]:
                o = npalign.local_align(q[k, : ql[k]], r[k, : rl[k]],
                                        sc.match, sc.mismatch,
                                        sc.gap_open, sc.gap_extend)
                assert int(got.opt[k]) == o.opt, (name, k)
                m = np.asarray(got.matched[k])
                i_f = np.asarray(got.i_first[k])
                i_l = np.asarray(got.i_last[k])
                for i, j in o.pairs:
                    assert m[j] and i_f[j] <= i <= i_l[j], (name, k, i, j)
            log(f"[{name}] numpy oracle agrees on {oracle_lanes} lanes")
        t_k, ks = _timed(compiled, args, reps)
        t_x, xs = _timed(xla, args, reps)
        out[name] = {"kernel_ms": t_k * 1e3, "xla_ms": t_x * 1e3,
                     "kernel_runs_ms": [x * 1e3 for x in ks],
                     "xla_runs_ms": [x * 1e3 for x in xs]}
        log(f"[{name}] per call (median of {reps}, warm): kernel "
            f"{t_k * 1e3:.3f} ms, XLA {t_x * 1e3:.3f} ms, "
            f"speed-up {t_x / t_k:.1f}x")
    return out


def _write_fasta(path, records):
    from consent_jax.io import seqs

    with open(path, "w") as fh:
        for name, codes in records:
            fh.write(f">{name}\n{seqs.decode(codes)}\n")


def _read_fasta(path) -> dict:
    from consent_jax.io import seqs
    from consent_jax.io.fasta import iter_fastx

    return {n: seqs.encode(s) for n, s in iter_fastx(path)}


def simulate_dataset(genome_mb: float, workdir: str,
                     read_len: int = READ_LEN, seed: int = SEED,
                     coverage: float = COVERAGE, name: str = "reads"):
    from consent_jax.testing import simulate

    t0 = time.perf_counter()
    genome, reads = simulate.simulate(
        genome_len=int(genome_mb * 1e6), coverage=coverage,
        read_len=read_len, error_rate=ERROR_RATE, seed=seed,
    )
    reads_fa = os.path.join(workdir, f"{name}.fasta")
    _write_fasta(reads_fa, [(r.name, r.codes) for r in reads])
    log(f"simulated {genome_mb} Mb genome at {coverage}x, {len(reads)} reads "
        f"({sum(len(r.codes) for r in reads) / 1e6:.2f} Mb) in "
        f"{time.perf_counter() - t0:.1f} s")
    return genome, reads, reads_fa


def _stage_table():
    from consent_jax.utils.observe import GLOBAL_STATS

    snap = GLOBAL_STATS.snapshot()
    return {
        "seconds": {k: round(v, 3) for k, v in sorted(snap["seconds"].items())},
        "counts": dict(sorted(snap["counts"].items())),
    }


def _reset_stats():
    from consent_jax.utils.observe import GLOBAL_STATS

    GLOBAL_STATS.seconds.clear()
    GLOBAL_STATS.counts.clear()


def phase_correct(genome, reads, reads_fa, workdir, extra_argv=(),
                  n_scored: int = N_SCORED,
                  floor: float = IDENTITY_FLOOR) -> dict:
    from consent_jax import cli
    from consent_jax.io import seqs
    from consent_jax.testing import metrics

    out_fa = os.path.join(workdir, "corrected.fasta")
    _reset_stats()
    t0 = time.perf_counter()
    rc = cli.main_correct(["--in", reads_fa, "--out", out_fa,
                           "--overlapper", "native", "--stats",
                           *extra_argv])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"main_correct exited {rc}")
    stages = _stage_table()
    out = _read_fasta(out_fa)
    by = {r.name: r for r in reads}
    names = sorted(out, key=lambda n: int(n[4:]) if n[4:].isdigit() else 0)
    pick = np.random.default_rng(0).permutation(len(names))[:n_scored]
    ids, raw = [], []
    for k in pick:
        r = by[names[k]]
        t = genome[r.g_beg : r.g_end]
        if r.reverse:
            t = seqs.revcomp(t)
        ids.append(metrics.identity(out[names[k]], t))
        if len(raw) < 50:
            raw.append(metrics.identity(r.codes, t))
    ident = float(np.mean(ids))
    res = {"wall_s": wall, "reads_in": len(reads), "reads_out": len(out),
           "windows": stages["counts"].get("windows.total"),
           "corrected_identity": ident, "raw_identity_50": float(np.mean(raw)),
           "n_scored": len(ids), "stages": stages}
    log("[correct] " + json.dumps(res))
    log(f"[correct] wall {wall:.1f} s, {res['windows']} windows, "
        f"identity {ident:.4f} on {len(ids)} reads (raw "
        f"{res['raw_identity_50']:.4f})")
    if ident < floor:
        raise AssertionError(f"corrected identity {ident:.4f} < {floor}")
    return res


def phase_polish(genome, reads_fa, workdir, extra_argv=(),
                 contig_len: int = CONTIG_LEN, draft_error: float = 0.01,
                 n_scored: int = N_CONTIGS_SCORED,
                 deepest_bucket: int | None = None) -> dict:
    """main_polish of a mutated draft cut into contigs; with
    deepest_bucket, the run must have used that fragment-slot bucket."""
    from consent_jax import cli
    from consent_jax.testing import metrics, simulate

    rng = np.random.default_rng(SEED + 1)
    draft, g2r = simulate.mutate(genome, rng, draft_error)
    starts = list(range(0, len(draft), contig_len))
    contigs = [(f"contig{k}", draft[o : o + contig_len])
               for k, o in enumerate(starts)]
    asm_fa = os.path.join(workdir, "draft.fasta")
    _write_fasta(asm_fa, contigs)
    out_fa = os.path.join(workdir, "polished.fasta")
    _reset_stats()
    t0 = time.perf_counter()
    rc = cli.main_polish(["--contigs", asm_fa, "--reads", reads_fa,
                          "--out", out_fa, "--overlapper", "native",
                          "--stats", *extra_argv])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"main_polish exited {rc}")
    stages = _stage_table()
    out = _read_fasta(out_fa)
    # truth of each contig: the genome span its draft bases came from
    d_ids, p_ids = [], []
    for k in np.linspace(0, len(contigs) - 1, min(n_scored, len(contigs))
                         ).astype(int):
        name, codes = contigs[k]
        g0, g1 = np.searchsorted(g2r, [starts[k], starts[k] + len(codes)])
        t = genome[g0:g1]
        d_ids.append(metrics.identity(codes, t))
        p_ids.append(metrics.identity(out[name], t))
    res = {"wall_s": wall, "contigs": len(contigs),
           "windows": stages["counts"].get("windows.total"),
           "draft_identity": float(np.mean(d_ids)),
           "polished_identity": float(np.mean(p_ids)),
           "n_scored": len(p_ids), "stages": stages}
    log("[polish] " + json.dumps(res))
    log(f"[polish] wall {wall:.1f} s, {res['windows']} windows, draft "
        f"{res['draft_identity']:.4f} -> polished "
        f"{res['polished_identity']:.4f} on {len(p_ids)} contigs")
    if not res["polished_identity"] > res["draft_identity"]:
        raise AssertionError("polishing did not raise identity")
    if deepest_bucket and not stages["counts"].get(
            f"consensus.windows_S{deepest_bucket}"):
        raise AssertionError(f"no window reached the S={deepest_bucket} "
                             f"bucket: {stages['counts']}")
    return res


def phase_mesh_correct(genome_mb: float, workdir: str,
                       read_len: int = READ_LEN, window: int = 500,
                       overlap: int = 50) -> dict:
    """main_correct over every local device vs engine.process_piles on
    one device: the FASTA must be byte-identical, and on GPUs every
    device must have held work."""
    import jax

    from consent_jax import cli
    from consent_jax.config import correct_preset
    from consent_jax.io import seqs
    from consent_jax.io.fasta import ReadIndex, write_fasta_record
    from consent_jax.overlap import minimizer as mz
    from consent_jax.pipeline import engine

    genome, reads, reads_fa = simulate_dataset(genome_mb, workdir,
                                               read_len)
    multi_fa = os.path.join(workdir, "corrected_mesh.fasta")
    t0 = time.perf_counter()
    rc = cli.main_correct(["--in", reads_fa, "--out", multi_fa,
                           "--overlapper", "native",
                           "--windowSize", str(window),
                           "--windowOverlap", str(overlap)])
    if rc != 0:
        raise RuntimeError(f"main_correct exited {rc}")
    t_multi = time.perf_counter() - t0
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in jax.devices()]
    index = ReadIndex.from_file(reads_fa)
    named = [(n, index[n]) for n in index.names()]
    cfg = correct_preset(window_size=window, window_overlap=overlap,
                         n_devices=1)
    piles = mz.all_vs_all_piles(named, mz.OverlapParams(), cfg.max_support)
    one_fa = os.path.join(workdir, "corrected_one.fasta")
    t0 = time.perf_counter()
    with open(one_fa, "w") as fh:
        for name, codes, solid in engine.process_piles(piles, index, cfg):
            if len(codes):
                write_fasta_record(fh, name, seqs.decode(codes, solid))
    t_one = time.perf_counter() - t0
    with open(multi_fa, "rb") as a, open(one_fa, "rb") as b:
        same = a.read() == b.read()
    res = {"devices": len(jax.devices()), "fasta_identical": same,
           "bytes": os.path.getsize(multi_fa), "wall_mesh_s": t_multi,
           "wall_one_device_s": t_one, "peak_bytes_per_device": peaks}
    log("[mesh-correct] " + json.dumps(res))
    if not same:
        raise AssertionError("mesh FASTA differs from the one-device FASTA")
    if jax.devices()[0].platform == "gpu" and min(peaks) <= 0:
        raise AssertionError(f"a device held no work: {peaks}")
    return res


def window_batch(B: int, S: int, Lf: int = 512, Lt: int = 640,
                 seed: int = 0):
    """B consensus windows of S fragment slots at the engine's widths:
    every slot is a noisy copy of its window's template (10% error,
    start offsets d0 in [-16, 48), a tenth of the slots empty).
    Returns numpy (frags [B*S, Lf], frag_len, tpl [B, Lt], tpl_len,
    d0 [B*S])."""
    from consent_jax.testing import simulate

    rng = np.random.default_rng(seed)
    tpl = rng.integers(0, 4, (B, Lt), dtype=np.uint8)
    tl = rng.integers(3 * Lt // 4, Lt + 1, B).astype(np.int32)
    q, ql, _, _, d0 = simulate.alignment_lanes(
        B * S, Lf, Lt, d0_range=(-16, 48), empty_frac=0.1, seed=seed,
        ref=np.repeat(tpl, S, axis=0), ref_len=np.repeat(tl, S))
    return q, ql, tpl, tl, d0


def phase_mesh_votes(B: int = 8, S: int = 152) -> dict:
    """Consensus votes with the fragment slots of each window sharded
    over a `frag` mesh of every local device, vs one device."""
    import jax
    import jax.numpy as jnp

    from consent_jax.config import correct_preset
    from consent_jax.ops import consensus as cons_ops
    from consent_jax.ops.align import Scoring
    from consent_jax.parallel import mesh as mesh_mod

    cfg = correct_preset()
    sc = Scoring(max_hgap=cfg.consensus_max_hgap, band=cfg.consensus_band)
    q, ql, tpl, tl, d0 = window_batch(B, S, seed=3)
    frags = q.reshape(B, S, -1)
    args = (jnp.asarray(frags), jnp.asarray(ql.reshape(B, S)),
            jnp.asarray(tpl), jnp.asarray(tl))
    fd0 = jnp.asarray(d0.reshape(B, S))
    ref = cons_ops.consensus_votes(*args, S=S, min_column_support=2,
                                   scoring=sc, frag_d0=fd0)
    nd = len(jax.devices())
    m = mesh_mod.make_mesh(nd, frag_axis=nd)
    got = mesh_mod.sharded_consensus_step(m, *args, S=S, scoring=sc,
                                          frag_d0=fd0)
    same = all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(ref, got))
    res = {"frag_devices": nd, "B": B, "S": S, "votes_equal": same}
    log("[mesh-votes] " + json.dumps(res))
    if not same:
        raise AssertionError("frag-mesh votes differ from one device")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    ap.add_argument("--genome-mb", type=float, default=GENOME_MB,
                    help="cut only the genome length to fit a time limit")
    args = ap.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform "
              f"{jax.devices()[0].platform})", file=sys.stderr)
        return 2
    from consent_jax.utils.jaxcache import enable

    enable()
    info = phase_devices()
    with tempfile.TemporaryDirectory() as workdir:
        if args.chips == 4:
            if info["count"] < 4:
                raise RuntimeError(f"--chips 4 needs 4 GPUs, found "
                                   f"{info['count']}")
            phase_mesh_votes()
            phase_mesh_correct(min(args.genome_mb, 0.5), workdir)
        else:
            if args.genome_mb < GENOME_MB:
                log(f"reduced: genome {args.genome_mb} Mb of {GENOME_MB}")
            phase_kernel()
            genome, reads, reads_fa = simulate_dataset(args.genome_mb,
                                                       workdir)
            phase_correct(genome, reads, reads_fa, workdir)
            wide = simulate_dataset(WIDE_GENOME_MB, workdir, seed=SEED + 3,
                                    name="wide")
            phase_correct(wide[0], wide[1], wide[2], workdir,
                          extra_argv=("--windowSize", str(WIDE_WINDOW)))
            phase_polish(genome, reads_fa, workdir)
            # polishing depth: piles of ~80 reads per window reach the
            # deepest fragment-slot bucket (engine.S_BUCKETS, S=152)
            deep = simulate_dataset(DEEP_GENOME_MB, workdir, seed=SEED + 2,
                                    coverage=DEEP_COVERAGE, name="deep")
            phase_polish(deep[0], deep[2], workdir, deepest_bucket=152)
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
