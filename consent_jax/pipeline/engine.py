"""The per-read processing engine.

Orchestrates the full per-pile chain of the reference drivers
(processRead, src/CONSENT-correction.cpp:19-60 / processContig,
src/CONSENT-polishing.cpp:21-105):

  pile -> window positions -> fragment clipping -> [device] batched
  realign-vote consensus -> k-mer weighting -> DBG polish -> [device]
  batched stitch -> trim/drop.

Parallelism model (replaces the reference's CTPL thread pool): windows
from *many* reads are pooled and bucketed by fragment count into
fixed-shape device batches; stitching runs reads in lockstep rounds
(pipeline/stitch.py).  Everything is deterministic: results are emitted
in input pile order, matching the reference's future-ring ordering
(CONSENT-correction.cpp:96-135).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import jax
import numpy as np
import jax.numpy as jnp

from consent_jax.config import ConsentConfig
from consent_jax.core import dbg as dbg_mod
from consent_jax.core import postprocess, windows as win_mod
from consent_jax.core.sparse_counts import SparseCounts
from consent_jax.io import seqs
from consent_jax.io.paf import Pile
from consent_jax.ops import consensus as cons_ops
from consent_jax.ops import kmer as kmer_ops
from consent_jax.ops.align import Scoring, backend as align_backend
from consent_jax.pipeline import stitch as stitch_mod
from consent_jax.utils.observe import GLOBAL_STATS as STATS

S_BUCKETS = (4, 8, 16, 32, 64, 152)
MAX_B = 256     # windows per device call cap: beyond this, per-call
                # latency is amortized but compile time of the big
                # executables grows faster than the throughput gain


@dataclasses.dataclass
class WindowTask:
    """One window of one read, from clipping to polished consensus."""

    read_key: int
    window_idx: int
    pos: Tuple[int, int]
    frags: List[np.ndarray]          # template first
    d0s: Optional[List[int]] = None  # est. start column per fragment
    # filled by the engine:
    consensus: Optional[np.ndarray] = None
    solid: Optional[np.ndarray] = None
    counts: Optional[SparseCounts] = None


def _bucket_for(n: int, cap: int) -> int:
    for b in S_BUCKETS:
        if n <= b:
            return min(b, cap) if cap >= n else cap
    return cap


class ConsensusEngine:
    """Batched window-consensus executor."""

    def __init__(self, cfg: ConsentConfig):
        self.cfg = cfg
        self.scoring = Scoring(
            match=cfg.match_score,
            mismatch=cfg.mismatch_score,
            gap_open=cfg.gap_open,
            gap_extend=cfg.gap_extend,
            max_hgap=cfg.consensus_max_hgap,
            band=cfg.consensus_band,
        )
        # fragment slots cap: template + maxMSA support fragments
        # (deep -M raises it past the standard buckets)
        self.s_cap = max(S_BUCKETS[-1], cfg.max_msa + 1)
        self.Lf = self._round128(cfg.window_size)
        self.Lt = self._round128(cfg.window_size + cfg.frag_slack)
        if align_backend() == "cuda":
            from consent_jax.ops import gpu_align

            gpu_align.check(self.Lf, self.Lt, self.scoring)
        # device parallelism: window batches split over a 1-D `data`
        # mesh of the local devices via shard_map (the device analogue
        # of the reference's CTPL fan-out, CONSENT-correction.cpp:77).
        # Deep piles whose fragment slots exceed one device's lane
        # budget (polish with -M in the thousands) switch to the
        # (data, frag) 2-axis mesh: fragment slots shard over `frag`
        # and the vote reductions become psum all-reduces.
        n_local = len(jax.devices())
        self.n_devices = min(cfg.n_devices or n_local, n_local)
        nf = cfg.frag_devices
        if nf is None:
            nf = (
                self.n_devices
                if self.s_cap > cfg.device_lanes and self.n_devices > 1
                else 1
            )
        self.frag_devices = max(1, min(nf, self.n_devices))
        if self.n_devices > 1:
            from consent_jax.parallel import mesh as mesh_mod

            if self.frag_devices > 1:
                assert self.n_devices % self.frag_devices == 0
                self.mesh = mesh_mod.make_mesh(
                    self.n_devices, frag_axis=self.frag_devices
                )
            else:
                self.mesh = mesh_mod.make_data_mesh(self.n_devices)
        else:
            self.mesh = None
        self.max_lanes = cfg.device_lanes * self.n_devices

    @staticmethod
    def _round128(x: int) -> int:
        return (x + 127) // 128 * 128

    def run(self, tasks: Sequence[WindowTask]) -> None:
        """Compute consensus + counts + DBG polish for every task.

        ALL consensus_rounds refinement rounds run in ONE device
        dispatch per batch (intermediate consensuses are assembled on
        device — ops/consensus.py assemble_template_device — and
        realigned without touching the host), so each batch pays
        exactly one fetch round trip for its packed votes regardless
        of the round count.  Batches dispatch asynchronously and their
        fetch latency overlaps across the chain pool."""
        buckets: Dict[int, List[WindowTask]] = {}
        for t in tasks:
            n = min(len(t.frags), self.cfg.max_msa + 1)
            if n == 0 or len(t.frags[0]) == 0:
                t.consensus = np.empty(0, np.uint8)
                t.solid = np.empty(0, bool)
                t.counts = SparseCounts.from_dense(
                    np.zeros(1, np.int32))
                continue
            b = _bucket_for(n, self.s_cap)
            if self.frag_devices > 1:
                # fragment slots shard over `frag`: equal shards
                nf = self.frag_devices
                b = -(-b // nf) * nf
            buckets.setdefault(b, []).append(t)

        jobs: List[Tuple[List[WindowTask], int]] = []
        for S, ts in buckets.items():
            STATS.add(f"consensus.windows_S{S}", len(ts))
            max_b = self._max_b(S)
            for lo in range(0, len(ts), max_b):
                jobs.append((ts[lo : lo + max_b], S))

        rounds = max(1, self.cfg.consensus_rounds)
        # Per-job chains (upload+dispatch -> fetch -> host post) are
        # independent; fanning them over the "chain" pool overlaps
        # each job's UPLOAD and fetch latency with other jobs' device
        # compute and host work — a serial dispatch loop would pay
        # every upload round trip back-to-back before any fetch
        # starts.  Batch building stays on the caller thread (numpy
        # under the GIL anyway); everything device-facing runs in the
        # chain.  The inner window fan-out runs on the separate
        # "work" pool (see utils/hostpool.py on nesting).
        from consent_jax.utils.hostpool import host_pool

        # chains spend most of their time BLOCKED on transfers (GIL
        # released), so the chain pool exceeds the core count — more
        # in-flight transfers, same CPU footprint
        import os as _os

        n_chain = max(4, self.cfg.n_workers or _os.cpu_count() or 1)
        pool = host_pool(n_chain, kind="chain")
        futs = []
        for sub, S in jobs:
            with STATS.timer("consensus.build_batch", len(sub)):
                arrays = self._build_arrays(sub, S)
            if pool is not None and len(jobs) > 1:
                futs.append(
                    pool.submit(self._job_chain, sub, S, arrays,
                                rounds)
                )
            else:
                self._job_chain(sub, S, arrays, rounds)
        for f in futs:
            f.result()

    def _job_chain(self, sub, S, arrays, rounds):
        """Upload+dispatch -> one fetch -> host post per batch: the
        refinement rounds AND the final consensus assembly run fused
        inside the dispatch — the download is the 2-bit-packed
        consensus (~170 bytes/window instead of ~4.5 KB of votes)."""
        frags, frag_len, frag_d0, tpl, tpl_len = arrays
        with STATS.timer("consensus.dispatch", len(sub)):
            dev = self._dispatch(S, frags, frag_len, frag_d0, tpl,
                                 tpl_len, rounds)
        with STATS.timer("consensus.device_votes", len(sub)):
            cons_list = self._fetch_cons(dev, tpl_len)
        self._host_post(sub, S, cons_list)

    def _max_b(self, S: int) -> int:
        """Windows per device call for bucket S (multiple of the
        data-axis size so shard_map gets equal shards)."""
        d = self.n_devices // self.frag_devices
        return max(d, min(self.max_lanes // S, MAX_B) // d * d)

    def _pad_b(self, n: int, max_b: int) -> int:
        """Window-batch sizes come from a TWO-point set per fragment
        bucket — {tail_b, max_b} — so at most two executables exist
        per (bucket, HLO) pair.  Ragged or laddered shapes would each
        trigger a compile, and tail batches (one per bucket per chunk)
        would land on fresh sizes all run long, billing compiles to
        the steady state; the padding compute for a tiny tail is
        microseconds."""
        d = self.n_devices // self.frag_devices
        tail_b = min(d * -(-16 // d), max_b)  # >= 16, divisible by d
        if n <= tail_b:
            return tail_b
        return max_b

    def _build_arrays(self, ts, S):
        cfg = self.cfg
        B = self._pad_b(len(ts), self._max_b(S))
        frags = np.zeros((B, S, self.Lf), dtype=np.uint8)
        frag_len = np.zeros((B, S), dtype=np.int32)
        frag_d0 = np.zeros((B, S), dtype=np.int32)
        tpl = np.zeros((B, self.Lt), dtype=np.uint8)
        tpl_len = np.zeros(B, dtype=np.int32)
        for b, t in enumerate(ts):
            n_use = min(len(t.frags), cfg.max_msa + 1, S)
            use = t.frags[:n_use]
            for s, f in enumerate(use):
                L = min(len(f), self.Lf)
                frags[b, s, :L] = f[:L]
                frag_len[b, s] = L
            if t.d0s is not None:
                frag_d0[b, :n_use] = t.d0s[:n_use]
            tp = t.frags[0]
            tpl[b, : len(tp)] = tp
            tpl_len[b] = len(tp)
        # fragments travel 2-bit packed (4x fewer upload bytes); the
        # device unpacks before the kernel (cons_ops.unpack_bases)
        return (cons_ops.pack_bases_host(frags), frag_len, frag_d0,
                tpl, tpl_len)

    def _dispatch(self, S, frags, frag_len, frag_d0, tpl, tpl_len,
                  rounds=1):
        """Asynchronously dispatch one wire-format consensus step with
        all refinement rounds fused (one upload buffer in, one
        download buffer out); fetch the returned device array with
        _fetch_votes when needed."""
        cfg = self.cfg
        if self.frag_devices > 1:
            # deep-pile geometry: fragment slots shard over `frag`,
            # vote reductions psum over it (parallel/mesh.py)
            from consent_jax.parallel import mesh as mesh_mod

            return mesh_mod.sharded_consensus_step(
                self.mesh, frags, frag_len, tpl, tpl_len, S=S,
                min_column_support=cfg.min_column_support,
                scoring=self.scoring,
                frag_d0=frag_d0 if self.scoring.band else None,
                packed=True, frags_packed=True, rounds=rounds,
                assemble_out=True, warm_frac=cfg.warm_frac,
            )
        buf = cons_ops.wire_encode_inputs(
            frags, frag_len, tpl, tpl_len, frag_d0
        )
        Pb = frags.shape[-1]
        if self.mesh is not None:
            from consent_jax.parallel import mesh as mesh_mod

            return mesh_mod.sharded_wire_step(
                self.mesh, buf, S=S, Pb=Pb, Lt=self.Lt,
                min_column_support=cfg.min_column_support,
                scoring=self.scoring, rounds=rounds,
                assemble_out=True, warm_frac=cfg.warm_frac,
            )
        return cons_ops.consensus_votes_wire(
            jnp.asarray(buf), S=S, Pb=Pb, Lt=self.Lt,
            min_column_support=cfg.min_column_support,
            scoring=self.scoring, rounds=rounds, assemble_out=True,
            warm_frac=cfg.warm_frac,
        )

    def _fetch_cons(self, dev, tpl_len):
        """-> list of per-window assembled consensus code arrays."""
        if isinstance(dev, tuple) and not isinstance(dev, cons_ops.PackedVotes):
            # frag-axis assemble_out path: (packed codes, lengths)
            packed, lens = np.asarray(dev[0]), np.asarray(dev[1])
            Lt = packed.shape[1] * 4
            shifts = np.arange(4, dtype=np.uint8) * 2
            codes = ((packed[:, :, None] >> shifts) & 3).reshape(
                len(packed), Lt
            )
            return [codes[b, : lens[b]] for b in range(len(packed))]
        return cons_ops.wire_decode_cons(np.asarray(dev), self.Lt)

    def _host_post(self, ts, S, cons_list):
        """Host post-processing: counts, anchor gate, weighting, DBG
        polish (native C++ fast paths with Python fallbacks).

        The native path runs whole window SLICES per ctypes call
        (host.cpp host_post_batch) — the per-window Python/ctypes glue
        dominated this stage on small hosts — fanned out over the
        shared `--nproc`-sized pool (the native calls release the GIL,
        the host-side analogue of the reference's CTPL pool,
        CONSENT-correction.cpp:77)."""
        from consent_jax import native
        from consent_jax.utils.hostpool import host_pool

        cfg = self.cfg
        pool = host_pool(cfg.n_workers)
        with STATS.timer("consensus.kmer_dbg", len(ts)):
            if native.get_lib() is not None and len(ts) >= 2:
                uses = [
                    t.frags[: min(len(t.frags), cfg.max_msa + 1, S)]
                    for t in ts
                ]
                sups = [
                    min(cfg.common_kmers, len(u) // 2) for u in uses
                ]
                conss = [c[: self.Lt] for c in cons_list]

                def run_slice(span):
                    lo, hi = span
                    res = native.host_post_batch_native(
                        uses[lo:hi], conss[lo:hi], sups[lo:hi],
                        cfg.mer_size, cfg.solid_thresh,
                        cfg.max_branches, cfg.dbg_zone,
                        cfg.min_anchors,
                    )
                    if res is None:  # native failure: per-window path
                        for b in range(lo, hi):
                            self._host_post_one(ts[b], cons_list[b], S)
                        return
                    for b, (c, s, sp) in enumerate(res, lo):
                        ts[b].consensus = c
                        ts[b].solid = s
                        ts[b].counts = sp

                n = len(ts)
                if pool is not None and n >= 16:
                    # ~4 slices per worker for DBG load balance
                    import os as _os

                    k = 4 * (cfg.n_workers or _os.cpu_count() or 1)
                    step = max(1, -(-n // k))
                    spans = [
                        (lo, min(lo + step, n))
                        for lo in range(0, n, step)
                    ]
                    list(pool.map(run_slice, spans))
                else:
                    run_slice((0, n))
            elif pool is not None and len(ts) >= 8:
                list(
                    pool.map(
                        lambda b: self._host_post_one(
                            ts[b], cons_list[b], S
                        ),
                        range(len(ts)),
                    )
                )
            else:
                for b, t in enumerate(ts):
                    self._host_post_one(t, cons_list[b], S)

    def _host_post_one(self, t, cons, S):
        cfg = self.cfg
        from consent_jax import native

        cons = cons[: self.Lt]
        use = t.frags[: min(len(t.frags), cfg.max_msa + 1, S)]
        # fast path: the WHOLE post chain (counts, anchor gate,
        # solidity, DBG polish) in one native call — the Python/ctypes
        # glue between the individual native stages dominated this
        # stage under the host pools
        one = native.host_post_window_native(
            use, cons, cfg.mer_size, cfg.solid_thresh,
            cfg.max_branches, cfg.dbg_zone, cfg.min_anchors,
            min(cfg.common_kmers, len(use) // 2),
        )
        if one is not None:
            t.consensus, t.solid, t.counts = one
            return
        # native counting also returns the distinct k-mers so the
        # sparse view skips the 4^k flatnonzero scan (the former host
        # hot spot: ~0.6 ms/window at k=9)
        res = native.count_kmers_sparse_native(use, cfg.mer_size)
        if res is not None:
            dense, keys = res
            sparse = SparseCounts(keys, dense[keys].astype(np.int32))
        else:
            dense = kmer_ops.count_kmers_host(use, cfg.mer_size)
            sparse = SparseCounts.from_dense(dense)
        # MSA give-up gate (-c/-a): windows with fewer than
        # min_anchors anchor k-mers keep the raw template,
        # unweighted and unpolished (correctionMSA.cpp:31-36
        # returns piles[0], an uppercase = all-solid string).
        bmean_sup = min(cfg.common_kmers, len(use) // 2)
        n_anch = native.count_anchors_native(
            use, cfg.mer_size, bmean_sup
        )
        if n_anch is None:
            n_anch = kmer_ops.count_anchors_host(
                use, cfg.mer_size, bmean_sup
            )
        if n_anch < cfg.min_anchors:
            tpl_f = np.asarray(t.frags[0], dtype=np.uint8)
            t.consensus = tpl_f
            t.solid = np.ones(len(tpl_f), dtype=bool)
            t.counts = sparse
            return
        if len(cons) >= cfg.mer_size:
            solid = kmer_ops.solidity_mask(
                cons, dense, cfg.mer_size, cfg.solid_thresh
            )
            res = native.polish_correction_native(
                cons, solid, dense, cfg.mer_size, cfg.solid_thresh,
                cfg.max_branches, cfg.dbg_zone,
            )
            if res is not None:
                cons, solid = res
            else:
                cons, solid = dbg_mod.polish_correction(
                    cons, solid, dense, cfg.mer_size, cfg.solid_thresh,
                    cfg.max_branches, cfg.dbg_zone,
                )
        else:
            # too short for weighting: reference skips weighting and
            # polish (correctionMSA.cpp:43-46); keep as weak
            solid = np.zeros(len(cons), dtype=bool)
        t.consensus = cons
        t.solid = solid
        t.counts = sparse


def windows_of_pile(pile: Pile, read_index, cfg: ConsentConfig,
                    read_key: int) -> Optional[List[WindowTask]]:
    """Window positions + clipped fragments for one pile; None when the
    pile yields no window (the reference silently drops such
    reads/contigs — processRead returns "", CONSENT-correction.cpp:23-25)."""
    seq_map = win_mod.sequences_map(pile, read_index)
    q_len = len(seq_map[pile.q_name])
    cov = win_mod.coverage(q_len, pile.ov)
    pos = win_mod.window_positions(
        q_len, cov, cfg.min_support, cfg.window_size, cfg.window_overlap
    )
    if not pos:
        return None
    tasks = []
    for w_idx, (beg, end) in enumerate(pos):
        frags, d0s = win_mod.clip_fragments(
            pile, seq_map, beg, end, cfg.mer_size, with_offsets=True
        )
        tasks.append(
            WindowTask(read_key=read_key, window_idx=w_idx,
                       pos=(beg, end), frags=frags, d0s=d0s)
        )
    return tasks


def process_piles(
    piles: Iterable[Pile],
    read_index,
    cfg: ConsentConfig,
    batch_align=None,
    # 1024 reads/chunk halves the stitcher's lockstep device calls
    # (each lockstep round is one device round trip; lanes cap at
    # MAX_LANES_PER_CALL anyway) and fills consensus
    # batches with fewer tails; ~150 MB of piles in flight
    chunk_reads: int = 1024,
) -> Iterator[Tuple[str, np.ndarray, np.ndarray]]:
    """Full pipeline over a pile stream.

    Yields (name, codes, solid) per input pile, in order; dropped
    reads yield empty arrays (the caller skips empty output, as the
    reference does at CONSENT-correction.cpp:101-103).
    """
    engine = ConsensusEngine(cfg)
    if batch_align is None:
        from consent_jax.pipeline.device_align import make_fixed_aligner
        batch_align = make_fixed_aligner(cfg, mesh=engine.mesh)

    chunk: List[Pile] = []

    def geometry_stage(chunk: List[Pile]):
        """Chunk stage 0: window geometry (pure host).  Its own
        pipeline slot so chunk k+2's geometry overlaps chunk k+1's
        device consensus — ~2-3 s per chunk otherwise sits serially
        ahead of the first dispatch."""
        from consent_jax.utils.hostpool import host_pool

        all_tasks: List[WindowTask] = []
        per_read: List[Optional[List[WindowTask]]] = []
        with STATS.timer("windows.geometry", len(chunk)):
            pool = host_pool(cfg.n_workers, kind="work")
            if pool is not None and len(chunk) >= 8:
                per_read = list(
                    pool.map(
                        lambda kp: windows_of_pile(
                            kp[1], read_index, cfg, kp[0]
                        ),
                        enumerate(chunk),
                    )
                )
            else:
                per_read = [
                    windows_of_pile(pile, read_index, cfg, key)
                    for key, pile in enumerate(chunk)
                ]
            for tasks in per_read:
                if tasks:
                    all_tasks.extend(tasks)
        STATS.add("windows.total", len(all_tasks))
        return per_read, all_tasks

    def consensus_stage(geo):
        """Chunk stage 1: device consensus + host post."""
        per_read, all_tasks = geo
        engine.run(all_tasks)
        return per_read

    def stitch_stage(chunk: List[Pile], per_read):
        jobs: List[Optional[stitch_mod.StitchJob]] = []
        for key, pile in enumerate(chunk):
            tasks = per_read[key]
            if not tasks:
                jobs.append(None)
                continue
            raw = read_index[pile.q_name]
            job = stitch_mod.StitchJob(
                name=pile.q_name,
                raw_codes=raw,
                piles_pos=[t.pos for t in tasks],
                consensuses=[(t.consensus, t.solid) for t in tasks],
                templates=[
                    t.frags[0] if t.frags else np.empty(0, np.uint8)
                    for t in tasks
                ],
                counts=[t.counts for t in tasks],
                cfg=cfg,
            )
            jobs.append(job)
        with STATS.timer("stitch.total", len(chunk)):
            stitch_mod.run_stitch(
                [j for j in jobs if j is not None], batch_align
            )

        for pile, job in zip(chunk, jobs):
            if job is None:
                yield pile.q_name, np.empty(0, np.uint8), np.empty(0, bool)
                continue
            codes, solid = job.result()
            if cfg.trim:
                codes, solid = postprocess.trim_read(codes, solid, 1)
                if postprocess.drop_read(solid):
                    codes, solid = codes[:0], solid[:0]
            yield pile.q_name, codes, solid

    # chunk-level software pipeline: the next chunk's consensus stage
    # (device-heavy) runs on one background thread while the current
    # chunk's stitch stage (device + host) drains — output order is
    # unchanged because chunks are consumed and yielded in order.
    from concurrent.futures import ThreadPoolExecutor

    def chunks():
        buf: List[Pile] = []
        for pile in piles:
            buf.append(pile)
            if len(buf) >= chunk_reads:
                yield buf
                buf = []
        if buf:
            yield buf

    # three-slot software pipeline over chunks:
    #   geometry(k+2)  ||  consensus(k+1)  ||  stitch(k)
    # Two background threads; output order is unchanged because
    # chunks are consumed and yielded in order.
    it = chunks()
    first = next(it, None)
    if first is None:
        return
    with ThreadPoolExecutor(max_workers=1) as geo_pipe, \
            ThreadPoolExecutor(max_workers=1) as cons_pipe:
        cur = first
        geo_fut = geo_pipe.submit(geometry_stage, cur)
        nxt = next(it, None)
        nxt_geo_fut = (
            geo_pipe.submit(geometry_stage, nxt)
            if nxt is not None else None
        )
        cons_fut = cons_pipe.submit(consensus_stage, geo_fut.result())
        while True:
            per_read = cons_fut.result()
            if nxt_geo_fut is not None:
                following = next(it, None)
                geo_next = nxt_geo_fut.result()
                nxt_geo_fut = (
                    geo_pipe.submit(geometry_stage, following)
                    if following is not None else None
                )
                cons_fut = cons_pipe.submit(consensus_stage, geo_next)
            else:
                following = None
                cons_fut = None
            yield from stitch_stage(cur, per_read)
            if cons_fut is None:
                return
            cur, nxt = nxt, following
