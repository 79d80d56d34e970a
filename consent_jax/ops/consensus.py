"""Realign-vote window consensus (device side).

Device replacement for the reference's per-window MSABMAAC call
(BMEAN anchor-chained SPOA partial-order alignment, reference:
src/correctionMSA.cpp:29-49).  Instead of building a partial-order
graph, every fragment of a window is locally aligned to the window
template in one fixed-shape batch (ops/align.py), and the consensus is
read off per-column vote tallies of the match posterior:

  * substitution votes: fragments matched at template column j vote
    their aligned base,
  * deletion votes: fragments whose alignment span covers j without
    matching it vote to delete the column,
  * insertion votes: fragment bases falling between matches to
    consecutive matched columns vote, offset by offset, to extend an
    insertion after the left column (majority-of-covering rule).

Columns with fewer than `min_column_support` covering fragments keep
the template base — mirroring the reference's fallback to the raw
template when the MSA gives up (src/correctionMSA.cpp:34-36 returns
piles[0] when BMEAN returns nothing).

All tensors are fixed-shape [B windows, S fragment slots, ...]; ragged
piles are padded with zero-length fragments that vote for nothing.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from consent_jax.ops import align as align_ops

INS_CAP = 16  # max insertion bases tracked per column boundary

# Warm refinement rounds never realign fewer than this many fragment
# slots, whatever warm_frac says: the intermediate template is voted
# by these slots alone (template-first, best-match-first fill), and
# below 5 voters the CLR indel noise leaks into the template faster
# than the fraction saves kernel time.  Measured at the 10x e2e
# workload (shallow ~10-fragment piles, S=16 bucket, 400 reads,
# floor sweep recorded in PARITY.md): Sw=4 -> read identity 0.9831,
# Sw=5 -> 0.9864, Sw=6 -> 0.9864, full warm -> 0.9866 — the floor of
# 5 keeps warm_frac=0.25 accuracy-neutral on shallow piles as well as
# deep ones.  Env override is for experiments only.
import os as _os

WARM_MIN_SLOTS = int(_os.environ.get("CONSENT_WARM_MIN", "5"))


class WindowVotes(NamedTuple):
    """Per-window consensus description, all device arrays."""

    col_base: jnp.ndarray   # [B, W] int8: consensus base per template column
    col_del: jnp.ndarray    # [B, W] bool: column deleted
    ins_len: jnp.ndarray    # [B, W] int32: insertion length after column j
    ins_base: jnp.ndarray   # [B, W, INS_CAP] int8: insertion bases
    coverage: jnp.ndarray   # [B, W] int32: fragments covering each column
    n_matched: jnp.ndarray  # [B, W] int32: fragments matched at each column
    pre_len: jnp.ndarray    # [B] int32: insertion length before column 0
    pre_base: jnp.ndarray   # [B, INS_CAP] int8 (offset 0 = adjacent to col 0)
    suf_len: jnp.ndarray    # [B] int32: insertion length after the last column
    suf_base: jnp.ndarray   # [B, INS_CAP] int8 (offset 0 = adjacent to last col)


def _propagate_forward(vals: jnp.ndarray, is_start: jnp.ndarray,
                       sentinel: int) -> jnp.ndarray:
    """Per row: broadcast vals at segment-start columns rightward
    across each segment.  vals must never equal `sentinel`."""
    x = jnp.where(is_start, vals, sentinel)

    def op(a, b):
        return jnp.where(b == sentinel, a, b)

    return jax.lax.associative_scan(op, x, axis=-1)


def _propagate_backward(vals: jnp.ndarray, is_end: jnp.ndarray,
                        sentinel: int) -> jnp.ndarray:
    """Per row: broadcast vals at segment-end columns leftward."""
    return _propagate_forward(
        vals[..., ::-1], is_end[..., ::-1], sentinel
    )[..., ::-1]


def _nearest_valid_right(vals: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Per row, at each j: vals at the nearest valid column strictly to
    the right (-1 if none).  vals/valid: [..., W]."""
    x = jnp.where(valid, vals, -1)

    def op(a, b):
        return jnp.where(b == -1, a, b)

    at_or_after = jax.lax.associative_scan(op, x[..., ::-1], axis=-1)[..., ::-1]
    after = jnp.concatenate(
        [at_or_after[..., 1:], jnp.full_like(at_or_after[..., :1], -1)], axis=-1
    )
    return after


@functools.partial(
    jax.jit,
    static_argnames=("S", "min_column_support", "scoring", "axis_name"),
)
def consensus_votes(
    frags: jnp.ndarray,      # [B, S, Lf] uint8 codes
    frag_len: jnp.ndarray,   # [B, S] int32 (0 = empty slot)
    tpl: jnp.ndarray,        # [B, W] uint8
    tpl_len: jnp.ndarray,    # [B] int32 (== W normally)
    *,
    S: int,
    min_column_support: int = 2,
    scoring: align_ops.Scoring = align_ops.Scoring(),
    frag_d0: jnp.ndarray | None = None,  # [B, S] expected start column
    axis_name: str | None = None,  # mesh axis sharding the S dim
) -> WindowVotes:
    """Batched realign-vote consensus.  When the fragment-slot dim is
    sharded over a mesh axis (shard_map over `frag`), S is the *local*
    slot count and `axis_name` turns every per-window vote reduction
    into an all-reduce over that axis."""
    B, S_, Lf = frags.shape
    assert S_ == S
    W = tpl.shape[1]

    q = frags.reshape(B * S, Lf)
    q_len = frag_len.reshape(B * S)
    r = jnp.repeat(tpl, S, axis=0)
    r_len = jnp.repeat(tpl_len, S)
    d0 = None if frag_d0 is None else frag_d0.reshape(B * S)

    summ = align_ops.summary(q, q_len, r, r_len, scoring, d0=d0)
    N = B * S
    matched = summ.matched                               # [N, W]
    big = Lf + W + 10
    i_first = jnp.where(matched, summ.i_first, big)
    i_last = jnp.where(matched, summ.i_last, -1)

    # aligned base per column (captured by the aligner, no gather)
    base = summ.base                                     # [N, W]

    # coverage span of each fragment on the template
    rj = jnp.arange(W)[None, :]
    r_begin = jnp.min(jnp.where(matched, rj, big), axis=1, keepdims=True)
    r_end = jnp.max(jnp.where(matched, rj, -1), axis=1, keepdims=True)
    cover = (rj >= r_begin) & (rj <= r_end)              # [N, W]

    # insertions between consecutive matched columns
    nxt_first = _nearest_valid_right(i_first, matched)   # [N, W]
    has_bnd = matched & (nxt_first >= 0)
    ins_count = jnp.where(has_bnd, nxt_first - i_last - 1, 0)
    ins_count = jnp.clip(ins_count, 0, INS_CAP)

    # unpack up to INS_CAP inserted bases per boundary from the
    # aligner's 2-bit-packed capture (no gather)
    assert INS_CAP == align_ops.INS_PACK
    k = jnp.arange(INS_CAP)[None, None, :]
    ins_codes = (summ.ins_pack[:, :, None] >> (2 * k)) & 3   # [N, W, K]
    ins_valid = k < ins_count[:, :, None]                # [N, W, K]

    # ---- reduce over fragment slots per window ----
    # counts fit int16: bounded by the fragment-slot cap max_msa + 1,
    # which ConsentConfig.validate() rejects at >= 30000 (< 2^15 even
    # summed across frag shards); the narrow accumulator halves the
    # [B, S, ...] reduce traffic vs int32 — these reductions are the
    # epilogue's dominant byte stream
    def red(x):
        y = x.astype(jnp.int16).reshape(B, S, *x.shape[1:]).sum(
            axis=1, dtype=jnp.int16
        )
        if axis_name is not None:
            y = jax.lax.psum(y, axis_name)
        return y.astype(jnp.int32)

    onehot = (base[:, :, None] == jnp.arange(4)[None, None, :]) & matched[
        :, :, None
    ]
    votes_base = red(onehot)           # [B, W, 4]
    votes_del = red(cover & ~matched)  # [B, W]
    coverage = red(cover)              # [B, W]
    n_matched = red(matched)           # [B, W]

    cand = jnp.concatenate([votes_base, votes_del[:, :, None]], axis=2)
    winner = jnp.argmax(cand, axis=2)                    # [B, W]; 4 == delete
    keep_tpl = coverage < min_column_support
    col_base = jnp.where(
        keep_tpl | (winner == 4), tpl.astype(jnp.int32), winner
    ).astype(jnp.int8)
    col_del = (winner == 4) & ~keep_tpl

    # ---- insertion majority per boundary ----
    votes_bnd = red(has_bnd)           # [B, W]
    more = red(ins_count[:, :, None] > k)  # [B, W, K]
    stop = votes_bnd[:, :, None] - more
    extend = more > stop                                 # strict majority
    ins_len = jnp.cumprod(extend.astype(jnp.int32), axis=2).sum(axis=2)

    ins_onehot = (
        (ins_codes[:, :, :, None] == jnp.arange(4)[None, None, None, :])
        & ins_valid[:, :, :, None]
    )
    ins_votes = red(ins_onehot)        # [B, W, K, 4]
    ins_base = jnp.argmax(ins_votes, axis=3).astype(jnp.int8)

    # ---- equal-base-run conservation votes ----
    # Inside a run of equal template bases every column is matched on
    # SOME optimal path, so the union-of-paths posterior never exposes
    # an indel there (the per-column and boundary votes above see
    # nothing) — exactly where CLR indels concentrate.  Base-count
    # conservation does expose them: an anchored fragment consumes
    # i_last[run_end] - i_first[run_begin] + 1 query bases across the
    # run; deficit vs the run length votes deletions of run columns,
    # surplus votes insertions of the run base, majority-aggregated
    # per unit like the boundary insertions.
    tpl32 = tpl.astype(jnp.int32)
    colw = jnp.broadcast_to(rj, (B, W))
    valid_col = colw < tpl_len[:, None]
    prev_tpl = jnp.pad(tpl32[:, :-1], ((0, 0), (1, 0)),
                       constant_values=-1)
    is_start_w = (
        (colw == 0) | (tpl32 != prev_tpl) | ~valid_col
        | (colw == tpl_len[:, None])
    )
    is_end_w = jnp.concatenate(
        [is_start_w[:, 1:], jnp.ones((B, 1), bool)], axis=1
    )
    SENT = -(1 << 20)
    rbeg = _propagate_forward(colw, is_start_w, SENT)
    rend = _propagate_backward(colw, is_end_w, SENT)
    run_len = rend - rbeg + 1

    def rep(x):
        return jnp.repeat(x, S, axis=0)

    # ONE forward scan carries both run-start values each fragment
    # needs — i_first[rbeg] and matched[rbeg], packed into one int32 —
    # and the run-END values need no backward scan at all: evaluated
    # at an end column j, i_last[rend] == i_last[j] and matched[rend]
    # == matched[j].  (Replaces four full-width scans.)
    is_start = rep(is_start_w)
    pk = _propagate_forward(
        i_first * 2 + matched.astype(jnp.int32), is_start, SENT
    )
    fb = pk >> 1                                         # i_first[rbeg]
    m_beg = (pk & 1) == 1                                # matched[rbeg]
    at_end = rep(is_end_w & valid_col)
    anch_end = m_beg & matched & at_end
    consumed = i_last - fb + 1
    # deficits are impossible at run_len == 1 (consumed >= 1), but
    # single-column surpluses are real (a deleted base whose context
    # is unique still blurs into i_first < i_last at that column)
    deficit = jnp.where(anch_end, rep(run_len) - consumed, 0)

    kk2 = jnp.arange(INS_CAP)[None, None, :]
    n_anch = red(anch_end)                               # [B, W]
    del_more = red(
        (deficit[:, :, None] > kk2) & anch_end[:, :, None]
    )
    del_run = jnp.cumprod(
        (del_more > n_anch[:, :, None] - del_more).astype(jnp.int32),
        axis=2,
    ).sum(axis=2)
    ins_more = red(
        (-deficit[:, :, None] > kk2) & anch_end[:, :, None]
    )
    ins_run = jnp.cumprod(
        (ins_more > n_anch[:, :, None] - ins_more).astype(jnp.int32),
        axis=2,
    ).sum(axis=2)
    gate = (n_anch < min_column_support) | keep_tpl
    del_run = jnp.where(gate, 0, jnp.minimum(del_run, run_len - 1))
    ins_run = jnp.where(gate, 0, ins_run)

    # apply: delete the last del_run columns of each run ...
    del_back = _propagate_backward(del_run, is_end_w, SENT)
    col_del = col_del | ((rend - colw) < del_back)
    # ... and splice ins_run copies of the run base before the
    # existing insertion at the run's end column: result[k] = run base
    # for k < ins_run, else ins_base[k - ins_run] — a shift-right by
    # ins_run via its bit decomposition (static pads/slices, no
    # take_along_axis gather)
    kk3 = jnp.arange(INS_CAP)[None, None, :]
    irun = ins_run[:, :, None]
    x = ins_base.astype(jnp.int32)
    for b in (1, 2, 4, 8):
        shifted = jnp.pad(x[:, :, :-b], ((0, 0), (0, 0), (b, 0)))
        x = jnp.where((irun & b) != 0, shifted, x)
    ins_base = jnp.where(kk3 < irun, tpl32[:, :, None], x).astype(
        jnp.int8
    )
    ins_len = jnp.clip(ins_len + ins_run, 0, INS_CAP)

    # ---- window-edge insertions ----
    # Fragments matched at template column 0 vote their unmatched leading
    # bases as an insertion before the window; symmetric for the last
    # real column.  Offsets count outward from the window edge.
    kk = jnp.arange(INS_CAP)[None, :]                    # [1, K]

    pre_valid = matched[:, 0]                            # [N]
    pre_cnt = jnp.where(pre_valid, jnp.clip(i_first[:, 0], 0, INS_CAP), 0)
    pre_idx = jnp.clip(i_first[:, 0:1] - 1 - kk, 0, Lf - 1)       # [N, K]
    pre_codes = jnp.take_along_axis(q.astype(jnp.int32), pre_idx, axis=1)
    pre_ok = kk < pre_cnt[:, None]
    pre_len, pre_base = _edge_majority(
        pre_valid, pre_cnt, pre_codes, pre_ok, B, S, axis_name
    )

    last_col = jnp.clip(r_len - 1, 0, W - 1)             # [N]
    m_last = jnp.take_along_axis(matched, last_col[:, None], axis=1)[:, 0]
    il_last = jnp.take_along_axis(i_last, last_col[:, None], axis=1)[:, 0]
    suf_valid = m_last
    suf_cnt = jnp.where(
        suf_valid, jnp.clip(q_len - 1 - il_last, 0, INS_CAP), 0
    )
    suf_idx = jnp.clip(il_last[:, None] + 1 + kk, 0, Lf - 1)
    suf_codes = jnp.take_along_axis(q.astype(jnp.int32), suf_idx, axis=1)
    suf_ok = kk < suf_cnt[:, None]
    suf_len, suf_base = _edge_majority(
        suf_valid, suf_cnt, suf_codes, suf_ok, B, S, axis_name
    )

    return WindowVotes(
        col_base=col_base,
        col_del=col_del,
        ins_len=ins_len,
        ins_base=ins_base,
        coverage=coverage,
        n_matched=n_matched,
        pre_len=pre_len,
        pre_base=pre_base,
        suf_len=suf_len,
        suf_base=suf_base,
    )


def assemble_template_device(
    v: WindowVotes,
    tpl_len: jnp.ndarray,  # [B] int32: this round's template lengths
    Lt: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Device-side consensus assembly for the NEXT refinement round.

    Bit-equal to the host chain `assemble_consensus_batch(votes,
    tpl_len)` followed by truncation to Lt and zero-padding — the
    layout (prefix insertion reversed, then per kept column its base
    followed by the insertion after it, then the suffix insertion) is
    a bounded prefix-sum placement, evaluated here as a gather-free
    masked reduction so refinement rounds never round-trip votes
    through the host (the device->host fetch round trip dominated the
    two-round pipeline).

    Returns (new_tpl [B, Lt] uint8, new_len [B] int32).
    """
    col_base = v.col_base.astype(jnp.int32)
    col_del = v.col_del
    B, W = col_base.shape
    kk = jnp.arange(INS_CAP, dtype=jnp.int32)

    def pack2(b):  # [..., K] base codes -> [...] int32, LSB first
        return jnp.sum(
            (b.astype(jnp.int32) & 3) << (2 * kk), axis=-1
        ).astype(jnp.int32)

    ins_pack = pack2(v.ins_base)                     # [B, W]
    pre_pack = pack2(v.pre_base)                     # [B]
    suf_pack = pack2(v.suf_base)                     # [B]
    pre = v.pre_len.astype(jnp.int32)
    suf = v.suf_len.astype(jnp.int32)

    colj = jnp.arange(W, dtype=jnp.int32)[None, :]
    valid = colj < tpl_len[:, None]
    keep = (valid & ~col_del).astype(jnp.int32)
    il = jnp.where(valid, v.ins_len.astype(jnp.int32), 0)
    cnt = keep + il                                  # bases from col j
    # absolute (prefix-included) inclusive segment ends per column
    e = pre[:, None] + jnp.cumsum(cnt, axis=1)       # [B, W]
    start = e - cnt
    main_end = e[:, -1:]                             # [B, 1]
    total = main_end[:, 0] + suf
    # everything needed per column, packed into one int32 so the
    # column->position placement is TWO masked reductions (start fits
    # 14 bits: <= pre + 17*W < 2^14 at the engine's Lt)
    meta = (start << 3) | (keep << 2) | (col_base & 3)

    # position t belongs to column j(t) = #{j : e[b,j] <= t}; e is
    # non-decreasing so the one-hot of j(t) is the edge of the
    # comparison mask along j — no gather, no scatter.
    #
    # Difference-weight form: sum_j v_j * onehot_j(t)
    #   = sum_j (v_j - v_{j+1}) * [t < e_j]      (v_W := 0)
    # because [t < e_j] is non-decreasing in j.  The multiply-reduce
    # over W is an int8 dot product: each int32 difference channel
    # splits into signed base-256 digits, the [B, Lt, W] {0,1} mask
    # contracts against [B, W, 7] digit planes in ONE int8->int32
    # dot_general (exact: digit sums are bounded by W * 128 < 2^16 and
    # the base-256 recombination wraps int32 to the true in-range
    # value).
    t3 = jnp.arange(Lt, dtype=jnp.int32)[None, :, None]   # [1, Lt, 1]
    mask8 = (t3 < e[:, None, :]).astype(jnp.int8)         # [B, Lt, W]

    def digits8(v32, n):
        """[B, W] int32 -> [B, W, n] signed base-256 digits."""
        outs = []
        v = v32
        for _ in range(n):
            lo = ((v + 128) & 255) - 128
            outs.append(lo.astype(jnp.int8))
            v = (v - lo) >> 8
        return jnp.stack(outs, axis=-1)

    def diff_w(v32):  # D_j = v_j - v_{j+1}, v_W := 0
        return v32 - jnp.concatenate(
            [v32[:, 1:], jnp.zeros((B, 1), jnp.int32)], axis=1
        )

    planes = jnp.concatenate(
        [digits8(diff_w(meta), 3), digits8(diff_w(ins_pack), 4)],
        axis=-1,
    )                                                     # [B, W, 7]
    sel = jax.lax.dot_general(
        mask8, planes,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32,
    )                                                     # [B, Lt, 7]
    meta_sel = sel[..., 0] + (sel[..., 1] << 8) + (sel[..., 2] << 16)
    ip_sel = (
        sel[..., 3] + (sel[..., 4] << 8) + (sel[..., 5] << 16)
        + (sel[..., 6] << 24)
    )

    tt = jnp.arange(Lt, dtype=jnp.int32)[None, :]
    in_pre = tt < pre[:, None]
    in_main = ~in_pre & (tt < main_end)
    in_suf = (tt >= main_end) & (tt < main_end + suf[:, None])
    startj = meta_sel >> 3
    keepj = (meta_sel >> 2) & 1
    cbj = meta_sel & 3
    off = tt - startj
    ins_idx = jnp.clip(off - keepj, 0, INS_CAP - 1)
    main_base = jnp.where(
        (off == 0) & (keepj == 1), cbj, (ip_sel >> (2 * ins_idx)) & 3
    )
    # prefix offsets count outward from column 0 -> reversed on output
    pre_sh = jnp.clip(pre[:, None] - 1 - tt, 0, INS_CAP - 1)
    pre_b = (pre_pack[:, None] >> (2 * pre_sh)) & 3
    suf_sh = jnp.clip(tt - main_end, 0, INS_CAP - 1)
    suf_b = (suf_pack[:, None] >> (2 * suf_sh)) & 3
    out = jnp.where(
        in_pre, pre_b,
        jnp.where(in_main, main_base, jnp.where(in_suf, suf_b, 0)),
    )
    new_len = jnp.minimum(total, Lt).astype(jnp.int32)
    return out.astype(jnp.uint8), new_len


def consensus_votes_rounds(
    frags, frag_len, tpl, tpl_len, *, S, rounds, min_column_support,
    scoring, frag_d0=None, axis_name=None, warm_frac: float = 1.0,
):
    """`rounds` refinement rounds fused into one device computation:
    each round's consensus is assembled ON DEVICE
    (assemble_template_device) and becomes the next round's template.
    Returns (final WindowVotes, final template lengths [B]) — the host
    assembles the final consensus once from the returned votes.

    warm_frac < 1 runs the WARM rounds (all but the last) on only the
    top ceil(S * warm_frac) fragment slots — the engine fills slots
    best-match-first, and a warm round's sole product is the next
    template, so trimming its depth trades almost no accuracy for a
    proportional cut of its alignment kernel (config.warm_frac).
    With the slot axis sharded (axis_name set) the warm cut is applied
    by zeroing the lengths of global slots >= Sw instead of slicing —
    bit-identical votes (empty slots contribute nothing to any
    reduction), with the global slot index derived from the shard's
    axis position; the kernel still runs all local lanes there."""
    import math

    Lt = tpl.shape[1]
    for _ in range(max(1, rounds) - 1):
        if warm_frac < 1.0 and axis_name is None:
            Sw = min(S, max(WARM_MIN_SLOTS, math.ceil(S * warm_frac)))
            v = consensus_votes(
                frags[:, :Sw], frag_len[:, :Sw], tpl, tpl_len, S=Sw,
                min_column_support=min_column_support, scoring=scoring,
                frag_d0=None if frag_d0 is None else frag_d0[:, :Sw],
                axis_name=axis_name,
            )
        elif warm_frac < 1.0:
            n_shards = jax.lax.psum(1, axis_name)
            S_global = S * n_shards
            Sw = min(S_global,
                     max(WARM_MIN_SLOTS, math.ceil(S_global * warm_frac)))
            slot = (jax.lax.axis_index(axis_name) * S
                    + jnp.arange(S))[None, :]
            fl_warm = jnp.where(slot < Sw, frag_len, 0)
            v = consensus_votes(
                frags, fl_warm, tpl, tpl_len, S=S,
                min_column_support=min_column_support, scoring=scoring,
                frag_d0=frag_d0, axis_name=axis_name,
            )
        else:
            v = consensus_votes(
                frags, frag_len, tpl, tpl_len, S=S,
                min_column_support=min_column_support, scoring=scoring,
                frag_d0=frag_d0, axis_name=axis_name,
            )
        tpl, tpl_len = assemble_template_device(v, tpl_len, Lt)
    v = consensus_votes(
        frags, frag_len, tpl, tpl_len, S=S,
        min_column_support=min_column_support, scoring=scoring,
        frag_d0=frag_d0, axis_name=axis_name,
    )
    return v, tpl_len


class PackedVotes(NamedTuple):
    """Transfer-optimized consensus description (~4x fewer bytes than
    WindowVotes): insertion bases 2-bit packed, per-column fields in
    the narrowest dtype, coverage diagnostics dropped.  The device->
    host fetch is the pipeline's dominant byte stream (each window
    fetches its votes exactly once), so this is sized for the wire;
    assemble_consensus_batch unpacks on the host."""

    col_base: jnp.ndarray   # [B, W] int8
    col_del: jnp.ndarray    # [B, W] int8 (0/1)
    ins_len: jnp.ndarray    # [B, W] uint8 (<= INS_CAP)
    ins_pack: jnp.ndarray   # [B, W] int32: 2 bits per inserted base
    pre_len: jnp.ndarray    # [B] int32
    pre_pack: jnp.ndarray   # [B] int32
    suf_len: jnp.ndarray    # [B] int32
    suf_pack: jnp.ndarray   # [B] int32


def pack_votes(v: WindowVotes) -> PackedVotes:
    kk = jnp.arange(INS_CAP, dtype=jnp.int32)

    def pack2(b):  # [..., K] base codes -> [...] int32, LSB first
        return jnp.sum(
            (b.astype(jnp.int32) & 3) << (2 * kk), axis=-1
        ).astype(jnp.int32)

    return PackedVotes(
        col_base=v.col_base.astype(jnp.int8),
        col_del=v.col_del.astype(jnp.int8),
        ins_len=v.ins_len.astype(jnp.uint8),
        ins_pack=pack2(v.ins_base),
        pre_len=v.pre_len.astype(jnp.int32),
        pre_pack=pack2(v.pre_base),
        suf_len=v.suf_len.astype(jnp.int32),
        suf_pack=pack2(v.suf_base),
    )


def unpack_votes_host(p: PackedVotes) -> WindowVotes:
    """Host-side inverse of pack_votes (numpy); coverage/n_matched are
    not reconstructed (diagnostics only, absent from the wire)."""
    kk = 2 * np.arange(INS_CAP, dtype=np.int32)

    def unpack2(x):
        return ((np.asarray(x)[..., None] >> kk) & 3).astype(np.int8)

    z = None
    return WindowVotes(
        col_base=np.asarray(p.col_base).astype(np.int8),
        col_del=np.asarray(p.col_del).astype(bool),
        ins_len=np.asarray(p.ins_len).astype(np.int32),
        ins_base=unpack2(p.ins_pack),
        coverage=z,
        n_matched=z,
        pre_len=np.asarray(p.pre_len),
        pre_base=unpack2(p.pre_pack),
        suf_len=np.asarray(p.suf_len),
        suf_base=unpack2(p.suf_pack),
    )


def pack_bases_host(codes: np.ndarray) -> np.ndarray:
    """Host: 2-bit pack base codes along the last axis (4 bases/byte,
    LSB first).  Length must be a multiple of 4 (engine lengths are
    multiples of 128).  Quarters the host->device fragment upload."""
    x = codes.reshape(*codes.shape[:-1], -1, 4).astype(np.uint8)
    return (
        x[..., 0] | (x[..., 1] << 2) | (x[..., 2] << 4) | (x[..., 3] << 6)
    )


def unpack_bases(packed: jnp.ndarray, L: int) -> jnp.ndarray:
    """Device inverse of pack_bases_host: [..., L//4] -> [..., L]."""
    shifts = jnp.arange(4, dtype=jnp.uint8) * 2
    x = (packed[..., None] >> shifts) & 3
    return x.reshape(*packed.shape[:-1], L)


@functools.partial(
    jax.jit,
    static_argnames=(
        "S", "min_column_support", "scoring", "axis_name", "frags_packed"
    ),
)
def consensus_votes_packed(
    frags, frag_len, tpl, tpl_len, *, S, min_column_support=2,
    scoring=align_ops.Scoring(), frag_d0=None, axis_name=None,
    frags_packed: bool = False,
) -> PackedVotes:
    """Wire-format consensus step: 2-bit-packed fragment upload
    (frags_packed=True) and packed vote download — the per-window
    transfer drops from ~27 KB to ~6 KB round trip."""
    if frags_packed:
        frags = unpack_bases(frags, frags.shape[-1] * 4)
    return pack_votes(
        consensus_votes(
            frags, frag_len, tpl, tpl_len, S=S,
            min_column_support=min_column_support, scoring=scoring,
            frag_d0=frag_d0, axis_name=axis_name,
        )
    )


# ---------------------------------------------------------------------------
# single-buffer wire format: ONE uint8 upload and ONE uint8 download
# per consensus call.  Per-array transfers each pay a fixed dispatch
# round trip (the host<->device link is latency-bound at production
# batch sizes), so all five inputs are concatenated into one row-major
# byte buffer and all eight packed-vote outputs into another.


def wire_encode_inputs(frags_packed, frag_len, tpl, tpl_len, frag_d0):
    """Host: [B, S*P | 4S | Lt | 4 | 4S] uint8 rows (little-endian
    int32 fields via numpy views)."""
    B, S, Pb = frags_packed.shape
    def b4(x):
        return np.ascontiguousarray(x.astype(np.int32)).view(np.uint8)

    return np.concatenate(
        [
            frags_packed.reshape(B, S * Pb),
            b4(frag_len).reshape(B, 4 * S),
            np.ascontiguousarray(tpl, dtype=np.uint8),
            b4(tpl_len[:, None]).reshape(B, 4),
            b4(frag_d0).reshape(B, 4 * S),
        ],
        axis=1,
    )


def _bitcast32(u8):
    """uint8[..., 4k] -> int32[..., k] (little-endian)."""
    return jax.lax.bitcast_convert_type(
        u8.reshape(*u8.shape[:-1], -1, 4), jnp.int32
    )


def pack_bases_device(codes: jnp.ndarray) -> jnp.ndarray:
    """Device inverse of unpack_bases: [..., L] codes -> [..., L//4]
    bytes (LSB first), matching pack_bases_host."""
    x = codes.reshape(*codes.shape[:-1], -1, 4).astype(jnp.uint8)
    return (
        x[..., 0]
        | (x[..., 1] << 2)
        | (x[..., 2] << 4)
        | (x[..., 3] << 6)
    )


@functools.partial(
    jax.jit,
    static_argnames=("S", "Pb", "Lt", "min_column_support", "scoring",
                     "axis_name", "rounds", "assemble_out", "warm_frac"),
)
def consensus_votes_wire(
    buf: jnp.ndarray,  # [B, S*Pb + 4S + Lt + 4 + 4S] uint8
    *,
    S: int,
    Pb: int,           # packed fragment bytes (Lf // 4)
    Lt: int,
    min_column_support: int = 2,
    scoring: align_ops.Scoring = align_ops.Scoring(),
    axis_name: str | None = None,
    rounds: int = 1,
    assemble_out: bool = False,
    warm_frac: float = 1.0,
) -> jnp.ndarray:      # [B, 7*Lt + 20] u8, or [B, Lt//4 + 4] assembled
    """All `rounds` refinement rounds in ONE dispatch (the round-1
    consensus is assembled on device and realigned against; see
    assemble_template_device) — each window round-trips its packed
    votes exactly once regardless of consensus_rounds.

    assemble_out=True (the production path) ALSO assembles the final
    consensus on device and returns only its 2-bit-packed codes +
    length — [B, Lt//4 + 4] bytes instead of [B, 7*Lt + 20], a ~27x
    smaller download for the latency-bound device->host link.  The
    result is bit-equal to host-assembling the final votes and
    truncating to Lt (which the host post chain did anyway)."""
    B = buf.shape[0]
    o = 0
    frags = unpack_bases(buf[:, : S * Pb].reshape(B, S, Pb), Pb * 4)
    o += S * Pb
    frag_len = _bitcast32(buf[:, o : o + 4 * S])
    o += 4 * S
    tpl = buf[:, o : o + Lt]
    o += Lt
    tpl_len = _bitcast32(buf[:, o : o + 4])[:, 0]
    o += 4
    frag_d0 = _bitcast32(buf[:, o : o + 4 * S])

    votes, w_len = consensus_votes_rounds(
        frags, frag_len, tpl, tpl_len, S=S, rounds=rounds,
        min_column_support=min_column_support, scoring=scoring,
        frag_d0=frag_d0 if scoring.band else None,
        axis_name=axis_name, warm_frac=warm_frac,
    )

    def u8_32(x):  # int32[...] -> uint8[..., flattened bytes]
        y = jax.lax.bitcast_convert_type(x, jnp.uint8)
        return y.reshape(B, -1)

    if assemble_out:
        cons, cons_len = assemble_template_device(votes, w_len, Lt)
        return jnp.concatenate(
            [pack_bases_device(cons), u8_32(cons_len[:, None])],
            axis=1,
        )

    v = pack_votes(votes)
    return jnp.concatenate(
        [
            v.col_base.astype(jnp.uint8),
            v.col_del.astype(jnp.uint8),
            v.ins_len.astype(jnp.uint8),
            u8_32(v.ins_pack),
            u8_32(v.pre_len[:, None]),
            u8_32(v.pre_pack[:, None]),
            u8_32(v.suf_len[:, None]),
            u8_32(v.suf_pack[:, None]),
            u8_32(w_len[:, None]),
        ],
        axis=1,
    )


def wire_decode_cons(arr: np.ndarray, Lt: int) -> list:
    """Host inverse of the assemble_out wire layout: list of per-window
    consensus code arrays (uint8, true lengths)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    Pb = Lt // 4
    packed = arr[:, :Pb]
    lens = arr[:, Pb : Pb + 4].copy().view(np.int32)[:, 0]
    shifts = np.arange(4, dtype=np.uint8) * 2
    codes = ((packed[:, :, None] >> shifts) & 3).reshape(len(arr), Lt)
    return [codes[b, : lens[b]] for b in range(len(arr))]


def wire_decode_votes(arr: np.ndarray, W: int
                      ) -> tuple[PackedVotes, np.ndarray]:
    """Host inverse of consensus_votes_wire's output layout.  Returns
    (votes, w_len) — w_len is the FINAL round's per-window template
    length (the host assembles the final consensus against it)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    o = 0

    def take(n):
        nonlocal o
        out = arr[:, o : o + n]
        o += n
        return out

    def i32(u8):
        return np.ascontiguousarray(u8).view(np.int32)

    col_base = take(W).astype(np.int8)
    col_del = take(W).astype(np.int8)
    ins_len = take(W)
    ins_pack = i32(take(4 * W))
    pre_len = i32(take(4))[:, 0]
    pre_pack = i32(take(4))[:, 0]
    suf_len = i32(take(4))[:, 0]
    suf_pack = i32(take(4))[:, 0]
    w_len = i32(take(4))[:, 0]
    return PackedVotes(
        col_base=col_base, col_del=col_del, ins_len=ins_len,
        ins_pack=ins_pack, pre_len=pre_len, pre_pack=pre_pack,
        suf_len=suf_len, suf_pack=suf_pack,
    ), w_len


def _edge_majority(valid, cnt, codes, ok, B, S, axis_name=None):
    """Majority insertion vote at a window edge.

    valid/cnt: [N]; codes/ok: [N, K].  Returns ([B], [B, K])."""
    K = codes.shape[1]
    kk = jnp.arange(K)[None, :]

    def red(x):
        y = x.reshape(B, S, *x.shape[1:]).sum(axis=1)
        if axis_name is not None:
            y = jax.lax.psum(y, axis_name)
        return y

    n_valid = red(valid.astype(jnp.int32))                        # [B]
    more = red((cnt[:, None] > kk).astype(jnp.int32))             # [B, K]
    stop = n_valid[:, None] - more
    extend = more > stop
    length = jnp.cumprod(extend.astype(jnp.int32), axis=1).sum(axis=1)
    onehot = (codes[:, :, None] == jnp.arange(4)[None, None, :]) & ok[:, :, None]
    votes = red(onehot.astype(jnp.int32))                         # [B, K, 4]
    base = jnp.argmax(votes, axis=2).astype(jnp.int8)
    return length, base


def assemble_consensus_batch(votes, w_lens) -> list:
    """Host: flatten each window's vote arrays into a consensus code
    array (uint8).  Layout: prefix insertion (outermost offset first),
    then per column j: base (unless deleted) followed by the insertion
    after j, then the suffix insertion.  Accepts WindowVotes or the
    wire-format PackedVotes."""
    if isinstance(votes, PackedVotes):
        from consent_jax import native

        fast = native.assemble_windows_native(
            votes.col_base, votes.col_del, votes.ins_len,
            votes.ins_pack, votes.pre_len, votes.pre_pack,
            votes.suf_len, votes.suf_pack, list(w_lens),
        )
        if fast is not None:
            return fast
        votes = unpack_votes_host(votes)
    col_base = np.asarray(votes.col_base)
    col_del = np.asarray(votes.col_del)
    ins_len = np.asarray(votes.ins_len)
    ins_base = np.asarray(votes.ins_base)
    pre_len = np.asarray(votes.pre_len)
    pre_base = np.asarray(votes.pre_base)
    suf_len = np.asarray(votes.suf_len)
    suf_base = np.asarray(votes.suf_base)
    out = []
    for b, w_len in enumerate(w_lens):
        cb = col_base[b, :w_len].astype(np.uint8)
        cd = col_del[b, :w_len]
        il = ins_len[b, :w_len]
        ib = ins_base[b, :w_len]
        # Expanded buffer: each column contributes (1 - del) + ins_len.
        counts = (~cd).astype(np.int64) + il
        total = int(counts.sum())
        buf = np.empty(total, dtype=np.uint8)
        ends = np.cumsum(counts)
        starts = ends - counts
        keep = ~cd
        buf[starts[keep]] = cb[keep]
        for j in np.flatnonzero(il > 0):
            s = starts[j] + (0 if cd[j] else 1)
            buf[s : s + il[j]] = ib[j, : il[j]]
        parts = []
        if pre_len[b]:
            # offsets count outward from column 0 -> reverse for output
            parts.append(pre_base[b, : pre_len[b]][::-1].astype(np.uint8))
        parts.append(buf)
        if suf_len[b]:
            parts.append(suf_base[b, : suf_len[b]].astype(np.uint8))
        out.append(np.concatenate(parts))
    return out


def assemble_consensus(votes: WindowVotes, window_idx: int, w_len: int) -> np.ndarray:
    """Host: assemble a single window (convenience wrapper)."""
    return assemble_consensus_batch(
        WindowVotes(*[np.asarray(x)[window_idx : window_idx + 1] for x in votes]),
        [w_len],
    )[0]
