"""Batched device aligner for the stitcher.

Pads ragged (query, ref) pair lists into fixed-shape buckets (lane
count = power of two, lengths = multiples of 128) so jit caches stay
small, runs the posterior aligner, and returns host AlignSpans.

With a data mesh (ConsensusEngine.mesh), the lane batch is split over
the local devices via shard_map — the stitch rounds of many reads
align on all chips at once, mirroring the window-consensus sharding.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from consent_jax.ops import align as align_ops
from consent_jax.pipeline.stitch import STITCH_SCORING, AlignSpan

MAX_LANES_PER_CALL = 1024

_SCORING = align_ops.Scoring(
    match=STITCH_SCORING["match"],
    mismatch=STITCH_SCORING["mismatch"],
    gap_open=STITCH_SCORING["gap_open"],
    gap_extend=STITCH_SCORING["gap_extend"],
)


def _spans_body(q, ql, r, rl):
    res = align_ops.summary(q, ql, r, rl, _SCORING)
    s = align_ops.summary_spans(res)
    return s.q_begin, s.q_end, s.r_begin, s.r_end, s.valid


@functools.partial(jax.jit, static_argnames=("Lq", "Lr"))
def _spans_wire_body(buf, *, Lq: int, Lr: int):
    """Single-buffer variant: ONE upload (2-bit packed q|r + lengths)
    and ONE [N, 5] int32 download — each per-array transfer pays a
    fixed round trip, and a stitch round is nine of them otherwise."""
    from consent_jax.ops.consensus import _bitcast32, unpack_bases

    N = buf.shape[0]
    o = 0
    q = unpack_bases(buf[:, : Lq // 4], Lq)
    o += Lq // 4
    r = unpack_bases(buf[:, o : o + Lr // 4], Lr)
    o += Lr // 4
    ql = _bitcast32(buf[:, o : o + 4])[:, 0]
    rl = _bitcast32(buf[:, o + 4 : o + 8])[:, 0]
    qb, qe, rb, re, valid = _spans_body(q, ql, r, rl)
    return jnp.stack(
        [qb, qe, rb, re, valid.astype(jnp.int32)], axis=1
    ).astype(jnp.int32)


@functools.lru_cache(maxsize=None)
def _sharded_spans_wire_fn(mesh: Mesh, Lq: int, Lr: int):
    fn = jax.shard_map(
        functools.partial(_spans_wire_body, Lq=Lq, Lr=Lr),
        mesh=mesh,
        in_specs=(P("data", None),),
        out_specs=P("data", None),
        check_vma=False,
    )
    return jax.jit(fn)


def _round_up(x: int, m: int) -> int:
    return max(m, (x + m - 1) // m * m)


def _next_pow2(x: int) -> int:
    n = 8
    while n < x:
        n *= 2
    return n


def device_batch_align(qs: List[np.ndarray], rs: List[np.ndarray],
                       fixed_len: int | None = None,
                       mesh: Optional[Mesh] = None) -> List[AlignSpan]:
    """Align each (qs[i], rs[i]) pair locally on device; returns spans.

    fixed_len pins the padded sequence length so every call hits a
    cached executable; without it the lengths round up to the batch
    maxima."""
    out: List[AlignSpan] = []
    for lo in range(0, len(qs), MAX_LANES_PER_CALL):
        out.extend(_collect(_dispatch_one(
            qs[lo : lo + MAX_LANES_PER_CALL],
            rs[lo : lo + MAX_LANES_PER_CALL], fixed_len, mesh)))
    return out


# at or below this lane count a device stitch round is mostly per-call
# latency; the native host path (posterior_spans_batch, bit-equal
# contract) takes it and frees the device for the consensus stage.
# Tunable for experiments (polish_bench sweeps it).
NATIVE_MAX_LANES = 8


class FixedAligner:
    """Stitch aligner with shapes pinned for one pipeline config.

    Exposes the async protocol run_stitch uses to interleave job
    groups (dispatch returns immediately; collect blocks on the
    fetch), so several groups' device rounds overlap their round
    trips.  Tiny batches route to the native host aligner (same span
    contract, no device call) — on an accelerator only: on the CPU
    the XLA path keeps results on one code path."""

    def __init__(self, cfg, mesh: Optional[Mesh] = None):
        self.fixed_len = _round_up(
            max(cfg.window_size + 2 * cfg.window_overlap,
                cfg.window_size + cfg.frag_slack),
            128,
        )
        if align_ops.backend() == "cuda":
            from consent_jax.ops import gpu_align

            gpu_align.check(self.fixed_len, self.fixed_len, _SCORING)
        self.mesh = mesh

    def _native(self, qs, rs):
        if align_ops.backend() == "xla":
            return None
        from consent_jax import native
        from consent_jax.pipeline.stitch import STITCH_SCORING

        out = native.posterior_spans_native(qs, rs, **STITCH_SCORING)
        if out is None:
            return None
        return [
            AlignSpan(int(out[i, 0]), int(out[i, 1]), int(out[i, 2]),
                      int(out[i, 3]), bool(out[i, 4]))
            for i in range(len(qs))
        ]

    def dispatch(self, qs, rs):
        if len(qs) <= NATIVE_MAX_LANES:
            spans = self._native(qs, rs)
            if spans is not None:
                return ("done", spans)
        assert len(qs) <= MAX_LANES_PER_CALL
        return ("dev", _dispatch_one(qs, rs, self.fixed_len, self.mesh))

    def collect(self, handle):
        kind, payload = handle
        if kind == "done":
            return payload
        return _collect(payload)

    def __call__(self, qs, rs):
        out: List[AlignSpan] = []
        for lo in range(0, len(qs), MAX_LANES_PER_CALL):
            out.extend(self.collect(self.dispatch(
                qs[lo : lo + MAX_LANES_PER_CALL],
                rs[lo : lo + MAX_LANES_PER_CALL])))
        return out


def make_fixed_aligner(cfg, mesh: Optional[Mesh] = None) -> "BatchAlignFn":
    """Aligner with shapes pinned for one pipeline config (and sharded
    over the engine's data mesh when given)."""
    return FixedAligner(cfg, mesh=mesh)


def _dispatch_one(qs, rs, fixed_len=None, mesh=None):
    """Asynchronously dispatch one batched span call; returns
    (device_array, n) — np.asarray on the array blocks."""
    from consent_jax.ops.consensus import pack_bases_host

    n = len(qs)
    lanes = _next_pow2(n)
    if mesh is not None:
        nd = mesh.devices.size
        lanes = nd * _next_pow2(-(-n // nd))
    Lq = _round_up(max(len(q) for q in qs), 128)
    Lr = _round_up(max(len(r) for r in rs), 128)
    if fixed_len is not None:
        Lq = max(Lq, fixed_len)
        Lr = max(Lr, fixed_len)
    q = np.zeros((lanes, Lq), dtype=np.uint8)
    r = np.zeros((lanes, Lr), dtype=np.uint8)
    ln = np.zeros((lanes, 2), dtype=np.int32)
    for i, (a, b) in enumerate(zip(qs, rs)):
        q[i, : len(a)] = a
        r[i, : len(b)] = b
        ln[i, 0] = len(a)
        ln[i, 1] = len(b)
    buf = np.concatenate(
        [pack_bases_host(q), pack_bases_host(r), ln.view(np.uint8)],
        axis=1,
    )
    if mesh is not None:
        dev = _sharded_spans_wire_fn(mesh, Lq, Lr)(
            jax.device_put(buf, NamedSharding(mesh, P("data", None)))
        )
    else:
        dev = _spans_wire_body(jnp.asarray(buf), Lq=Lq, Lr=Lr)
    return dev, n


def _collect(handle):
    dev, n = handle
    out = np.asarray(dev)
    return [
        AlignSpan(int(out[i, 0]), int(out[i, 1]), int(out[i, 2]),
                  int(out[i, 3]), bool(out[i, 4]))
        for i in range(n)
    ]
