"""Batched affine-gap local alignment — traceback-free.

This replaces both SPOA (consensus, reference: BMEAN submodule via
src/correctionMSA.cpp:32) and the striped Smith-Waterman library
(stitching, reference: src/correctionAlignment.cpp:48-93) with one
accelerator primitive: a batched Smith-Waterman whose per-row horizontal
dependency is resolved with an associative prefix-max scan, so each DP
row is one vectorized step — no scalar inner loop, no traceback.

Instead of a traceback, we compute the *match posterior*: a cell (i, j)
lies on an optimal local alignment with (i ~ j) matched iff

    fwd_match(i,j) + bwd_cont(i+1,j+1) == opt

where fwd_match is the best score of a local path ending with (i~j)
aligned and bwd_cont is the best (possibly empty) continuation starting
at (i+1, j+1).  Affine gaps cannot straddle a matched pair, so the
split is exact.  The posterior is never materialized as a [Lq, Lr]
tensor: the backward scan folds each row into per-column summaries
(matched?, first/last matched query row), which is all that consensus
voting and span extraction need.  The device never chases pointers;
the only O(Lq*Lr) stream is the int16 fwd_match rows.

Gap cost model: a gap of length g costs open + (g-1)*ext, matching the
SSW library's semantics used by the reference stitcher.

Within-row recurrence (the standard two-pass trick): with
  Ht[i][j] = max(0, H[i-1][j-1] + sub(i,j), F[i][j])     (no E term)
the horizontal state is exactly
  E[i][j]  = max_{k<j} (Ht[i][k] - open - (j-1-k)*ext)
because a horizontal gap run must start from a non-E cell (re-opening
from an E cell is never better since open >= ext > 0).  E is an
exclusive prefix-max of (Ht[i][k] + k*ext), one associative scan per row.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

NEG = -(2 ** 14)  # effectively -inf; int16-safe (scores stay < 2^14)


class Scoring(NamedTuple):
    match: int = 2
    mismatch: int = -4
    gap_open: int = 4     # cost of the first base of a gap
    gap_extend: int = 2   # cost of each further base
    # Maximum horizontal (reference-consuming) gap length the DP scores;
    # 0 = unlimited (exact affine SW).  A cap of 2^k shrinks the per-row
    # prefix-max scan to k steps — the consensus path uses 16 (longer
    # template deletions are instead routed through mismatches and
    # repaired by the DBG stage); the stitch path stays exact.
    max_hgap: int = 0
    # Diagonal band width (0 = full DP).  With band = B > 0 the DP only
    # fills cells with (j - d0) - i in [-B/2, B/2), where d0 is the
    # per-lane expected ref column of query base 0 (the fragment's clip
    # offset, estimated at clip time from the PAF span ratio).  Cells
    # outside the band are -inf.  Cuts the GPU kernel's row from Lr
    # to B slots — the structural win, since window fragments are
    # near-diagonal.  The kernel takes 128 or 256.
    band: int = 0


INS_PACK = 16  # inserted bases packed 2-bit into one int32 per column


class PosteriorSummary(NamedTuple):
    """Per-column posterior summaries, all [N, Lr] (query-row indices
    are int32; -1/Lq sentinels where unmatched).

    base / ins_pack are derived views of i_last (the GPU kernel reads
    them off the query it holds in shared memory):
      base[j]     = q[i_last[j]]            (the aligned base)
      ins_pack[j] = q[i_last[j]+1 .. +16] packed 2 bits/base, LSB first
    """

    opt: jnp.ndarray        # [N] optimal local score
    matched: jnp.ndarray    # [N, Lr] bool: column j matched on an optimal path
    i_first: jnp.ndarray    # [N, Lr] smallest matched query row (Lq if none)
    i_last: jnp.ndarray     # [N, Lr] largest matched query row (-1 if none)
    base: jnp.ndarray       # [N, Lr] int32
    ins_pack: jnp.ndarray   # [N, Lr] int32


def _prefix_max_exclusive(x: jnp.ndarray, axis: int,
                          max_window: int = 0) -> jnp.ndarray:
    """Exclusive running max along `axis` (identity NEG).  With
    max_window = G > 0, the max only looks back G entries (capped-gap
    scoring, see Scoring.max_hgap)."""
    L = x.shape[axis]
    if max_window and max_window < L:
        inc = x
        s = 1
        while s < max_window:
            shifted = jnp.full_like(inc, NEG)
            idx = [slice(None)] * x.ndim
            idx[axis] = slice(s, None)
            src = [slice(None)] * x.ndim
            src[axis] = slice(0, L - s)
            shifted = shifted.at[tuple(idx)].set(inc[tuple(src)])
            inc = jnp.maximum(inc, shifted)
            s *= 2
    else:
        inc = jax.lax.associative_scan(jnp.maximum, x, axis=axis)
    pad = [(0, 0)] * x.ndim
    pad[axis] = (1, 0)
    shifted = jnp.pad(inc, pad, constant_values=NEG)
    index = [slice(None)] * x.ndim
    index[axis] = slice(0, L)
    return shifted[tuple(index)]


@functools.partial(jax.jit, static_argnames=("sc",))
def posterior_summary(
    q: jnp.ndarray,       # [N, Lq] uint8 codes
    q_len: jnp.ndarray,   # [N] int32
    r: jnp.ndarray,       # [N, Lr] uint8 codes
    r_len: jnp.ndarray,   # [N] int32
    sc: Scoring = Scoring(),
    d0: jnp.ndarray | None = None,   # [N] expected ref col of q[0] (band)
) -> PosteriorSummary:
    """Forward + backward local-alignment fill with streaming posterior
    reduction.  Pure JAX (static shapes); ops/gpu_align.py runs the
    same contract as one CUDA kernel (including the banded variant's
    exact clipping semantics when sc.band > 0)."""
    N, Lq = q.shape
    Lr = r.shape[1]
    qi = q.astype(jnp.int16)
    ri = r.astype(jnp.int16)
    ref_mask = jnp.arange(Lr)[None, :] < r_len[:, None]           # [N, Lr]
    open_, ext = sc.gap_open, sc.gap_extend
    jcost = (jnp.arange(Lr, dtype=jnp.int16) * ext)               # j*ext

    band = sc.band
    if band:
        OFF = band // 2
        if d0 is None:
            d0 = jnp.zeros((N,), jnp.int32)
        # Kernel column of true column j.  Row i of the banded kernel
        # materializes only slots chat in [i - OFF, i + band - OFF)
        # (cells outside are -inf: they have no slot), and its ref view
        # is the window chat in [0, Lr) — columns outside that window
        # behave like ordinary out-of-ref cells (score floor 0).
        chat = jnp.arange(Lr)[None, :] - d0.astype(jnp.int32)[:, None]
        chat_ok = (chat >= 0) & (chat < Lr)

        def in_geom(i):
            rel = chat - i + OFF
            return (rel >= 0) & (rel < band)
    else:
        def in_geom(i):
            return True

    def row_scores(q_col, valid_row, i):
        sub = jnp.where(q_col[:, None] == ri, sc.match, sc.mismatch)
        ok = valid_row[:, None] & ref_mask
        if band:
            ok = ok & in_geom(i) & chat_ok
        return jnp.where(ok, sub, NEG).astype(jnp.int16)

    def band_clip(x, i):
        """Cells with no slot in row i of the banded kernel are -inf;
        no-op for full DP."""
        if not band:
            return x
        return jnp.where(in_geom(i), x, jnp.int16(NEG))

    # ---------------- forward fill ----------------
    def fwd_step(carry, xs):
        h_prev, f_prev = carry            # [N, Lr] int16, rows i-1
        q_col, i = xs
        valid = i < q_len                                        # [N]
        sub = row_scores(q_col, valid, i)                        # [N, Lr]
        h_diag = jnp.pad(h_prev[:, :-1], ((0, 0), (1, 0)))       # H[i-1][j-1]
        hm = (h_diag + sub).astype(jnp.int16)                    # match-entering
        f = jnp.maximum(h_prev - open_, f_prev - ext).astype(jnp.int16)
        ht = band_clip(
            jnp.maximum(jnp.maximum(hm, f), 0).astype(jnp.int16), i
        )
        e = (
            _prefix_max_exclusive(ht + jcost, axis=1, max_window=sc.max_hgap)
            - jcost - (open_ - ext)
        ).astype(jnp.int16)
        h = band_clip(jnp.maximum(ht, e), i)
        f = band_clip(f, i)
        h = jnp.where(valid[:, None], h, h_prev)
        f = jnp.where(valid[:, None], f, f_prev)
        return (h, f), hm

    h0 = jnp.zeros((N, Lr), jnp.int16)
    f0 = jnp.full((N, Lr), NEG, jnp.int16)
    (_, _), hm_all = jax.lax.scan(
        fwd_step, (h0, f0), (qi.T, jnp.arange(Lq)), length=Lq
    )
    # hm_all: [Lq, N, Lr] int16: best score ending with (i ~ j) matched
    opt = jnp.maximum(
        jnp.max(hm_all.astype(jnp.int32), axis=(0, 2)), 0
    )                                                            # [N] int32

    # ---------------- backward fill + streaming posterior ----------------
    opt16 = opt.astype(jnp.int16)

    def bwd_step(carry, xs):
        bh_next, bf_next, matched, i_first, i_last = carry
        q_col, hm_row, i = xs
        valid = i < q_len
        sub = row_scores(q_col, valid, i)
        bh_diag = jnp.pad(bh_next[:, 1:], ((0, 0), (0, 1)))      # bh[i+1][j+1]
        bm = (sub + bh_diag).astype(jnp.int16)
        bf = jnp.maximum(bh_next - open_, bf_next - ext).astype(jnp.int16)
        bt = band_clip(
            jnp.maximum(jnp.maximum(bm, bf), 0).astype(jnp.int16), i
        )
        be = (
            _prefix_max_exclusive(
                (bt - jcost)[:, ::-1], axis=1, max_window=sc.max_hgap
            )[:, ::-1]
            + jcost - (open_ - ext)
        ).astype(jnp.int16)
        bh = band_clip(jnp.maximum(bt, be), i)
        bf = band_clip(bf, i)
        bh = jnp.where(valid[:, None], bh, bh_next)
        bf = jnp.where(valid[:, None], bf, bf_next)

        on_path = (
            ((hm_row + bh_diag) == opt16[:, None])
            & (hm_row > NEG // 2)
            & (opt > 0)[:, None]
        )
        # descending i: overwriting i_first converges to the minimum;
        # i_last keeps the first (= largest) row seen.
        i_first = jnp.where(on_path, i, i_first)
        i_last = jnp.where(on_path & ~matched, i, i_last)
        matched = matched | on_path
        return (bh, bf, matched, i_first, i_last), None

    bh0 = jnp.zeros((N, Lr), jnp.int16)
    bf0 = jnp.full((N, Lr), NEG, jnp.int16)
    m0 = jnp.zeros((N, Lr), jnp.bool_)
    if0 = jnp.full((N, Lr), Lq, jnp.int32)
    il0 = jnp.full((N, Lr), -1, jnp.int32)
    (bh, bf, matched, i_first, i_last), _ = jax.lax.scan(
        bwd_step,
        (bh0, bf0, m0, if0, il0),
        (qi.T[::-1], hm_all[::-1], jnp.arange(Lq - 1, -1, -1)),
        length=Lq,
    )
    base, ins_pack = derive_base_ins(q, q_len, matched, i_last)
    return PosteriorSummary(
        opt=opt, matched=matched, i_first=i_first, i_last=i_last,
        base=base, ins_pack=ins_pack,
    )


def backend(platform: str | None = None) -> str:
    """The posterior aligner that runs on `platform` (default: the
    platform of JAX's first device): 'cuda', the Hopper kernel of
    ops/gpu_align.py, on a GPU; 'xla', posterior_summary, on the CPU."""
    platform = platform or jax.devices()[0].platform
    if platform == "gpu":
        return "cuda"
    if platform == "cpu":
        return "xla"
    raise RuntimeError(f"no posterior aligner for platform {platform!r}")


def summary(q, q_len, r, r_len, sc: Scoring = Scoring(), d0=None
            ) -> PosteriorSummary:
    """posterior_summary on the backend() of the default device."""
    if backend() == "cuda":
        from consent_jax.ops import gpu_align

        return gpu_align.posterior_summary(q, q_len, r, r_len, sc, d0=d0)
    return posterior_summary(q, q_len, r, r_len, sc, d0=d0)


def derive_base_ins(q, q_len, matched, i_last):
    """Gather-based base / packed-insertion derivation (the GPU
    kernel derives the same from the query in shared memory).
    Offsets past q_len pack as 0, unmatched columns are 0."""
    N, Lq = q.shape
    Lr = matched.shape[1]
    qi32 = q.astype(jnp.int32)
    safe_il = jnp.clip(jnp.where(matched, i_last, 0), 0, Lq - 1)
    base = jnp.where(
        matched, jnp.take_along_axis(qi32, safe_il, axis=1), 0
    )
    k = jnp.arange(INS_PACK)[None, None, :]
    gidx = safe_il[:, :, None] + 1 + k
    ins = jnp.take_along_axis(
        qi32, jnp.clip(gidx, 0, Lq - 1).reshape(N, Lr * INS_PACK), axis=1
    ).reshape(N, Lr, INS_PACK)
    ins = jnp.where(gidx < q_len[:, None, None], ins, 0)
    ins_pack = jnp.where(
        matched, jnp.sum(ins << (2 * k), axis=2).astype(jnp.int32), 0
    )
    return base, ins_pack


class SpanResult(NamedTuple):
    """Begin/end coordinates of one optimal local alignment per lane —
    the data the reference reads off SSW's Alignment struct
    (ref_begin/ref_end/query_begin/query_end,
    src/correctionAlignment.cpp:91-93)."""

    opt: jnp.ndarray        # [N]
    q_begin: jnp.ndarray    # [N] first matched query index (or 0)
    q_end: jnp.ndarray      # [N] last matched query index (or -1)
    r_begin: jnp.ndarray    # [N]
    r_end: jnp.ndarray      # [N]
    valid: jnp.ndarray      # [N] bool: any match


def summary_spans(s: PosteriorSummary) -> SpanResult:
    """Bounding box of matched cells (ties: union box — the reference's
    SSW picks one arbitrary optimum; tie behavior is unspecified there)."""
    N, Lr = s.matched.shape
    any_match = s.matched.any(axis=1)
    rj = jnp.arange(Lr)[None, :]
    big = Lr + 10
    r_begin = jnp.min(jnp.where(s.matched, rj, big), axis=1)
    r_end = jnp.max(jnp.where(s.matched, rj, -1), axis=1)
    q_begin = jnp.min(jnp.where(s.matched, s.i_first, big + Lr), axis=1)
    q_end = jnp.max(jnp.where(s.matched, s.i_last, -1), axis=1)
    return SpanResult(
        opt=s.opt,
        q_begin=jnp.where(any_match, q_begin, 0),
        q_end=jnp.where(any_match, q_end, -1),
        r_begin=jnp.where(any_match, r_begin, 0),
        r_end=jnp.where(any_match, r_end, -1),
        valid=any_match,
    )


