"""Mesh construction and sharded consensus dispatch.

The reference's only parallelism is a CTPL thread pool over piles
(SURVEY.md §2b, CONSENT-correction.cpp:76-135).  The device-mesh
equivalents here:

  * `data` axis — windows of a batch sharded across devices (the
    embarrassingly-parallel read/window data parallelism).  This is the
    production engine's axis: `shard_map` splits each window batch over
    the local devices, every device runs the same consensus step
    (CUDA aligner + XLA votes) on its shard, and no collective is
    needed.
  * `frag` axis — fragment slots of each window sharded across devices;
    the per-column vote reductions (sum over fragments) become
    `jax.lax.psum` all-reduces over this axis inside the shard_map body
    (ops/consensus.py's `axis_name` plumb).  Useful when piles are deep
    (polishing: maxSupport=20000) and windows few.

Multi-host runs shard piles across processes at the host level
(parallel/multihost.py); inside each host these meshes span the local
devices.

shard_map is used instead of bare GSPMD sharding annotations because the
hot path is an FFI kernel: an opaque custom call GSPMD cannot
partition.  Under shard_map each device traces the kernel on its local
shard shape, which is exactly the manual SPMD the workload wants.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from consent_jax.ops import align as align_ops
from consent_jax.ops import consensus as cons_ops


def make_mesh(
    n_devices: Optional[int] = None,
    frag_axis: int = 1,
) -> Mesh:
    """1- or 2-axis mesh over local devices: (data, frag)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    assert n % frag_axis == 0, (n, frag_axis)
    arr = np.array(devs[:n]).reshape(n // frag_axis, frag_axis)
    return Mesh(arr, ("data", "frag"))


def make_data_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-axis data mesh over local devices (the engine's mesh)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), ("data",))


def put_batch(mesh: Mesh, arrays, specs):
    """device_put host arrays with the given PartitionSpecs."""
    return tuple(
        jax.device_put(a, NamedSharding(mesh, sp))
        for a, sp in zip(arrays, specs)
    )


@functools.lru_cache(maxsize=None)
def sharded_votes_fn(
    mesh: Mesh,
    S: int,
    min_column_support: int,
    scoring: align_ops.Scoring,
    with_d0: bool,
    packed: bool = False,
    frags_packed: bool = False,
    rounds: int = 1,
    assemble_out: bool = False,
    warm_frac: float = 1.0,
):
    """jit(shard_map(consensus_votes)) over the mesh.

    With a `frag` axis of size nf > 1, each device holds S/nf fragment
    slots and the vote reductions all-reduce over `frag`; the returned
    callable still takes the full [B, S, ...] arrays.

    rounds > 1 fuses the refinement rounds on device (the psum'd votes
    are full reductions, so every frag shard assembles the identical
    next-round template locally — no extra collective); the callable
    then returns (votes, w_len) with the FINAL round's template
    lengths.
    """
    axes = dict(zip(mesh.axis_names, mesh.devices.shape))
    nf = axes.get("frag", 1)
    assert S % nf == 0, (S, nf)
    S_local = S // nf
    frag = "frag" if nf > 1 else None
    axis_name = "frag" if nf > 1 else None

    def body(frags, frag_len, tpl, tpl_len, frag_d0=None):
        if frags_packed:
            frags = cons_ops.unpack_bases(frags, frags.shape[-1] * 4)
        if rounds > 1 or assemble_out:
            v, w_len = cons_ops.consensus_votes_rounds(
                frags, frag_len, tpl, tpl_len,
                S=S_local, rounds=rounds,
                min_column_support=min_column_support,
                scoring=scoring,
                frag_d0=frag_d0,
                axis_name=axis_name,
                warm_frac=warm_frac,
            )
            if assemble_out:
                # votes are full reductions (psum'd over frag), so
                # every shard assembles the identical consensus
                cons, cl = cons_ops.assemble_template_device(
                    v, w_len, tpl.shape[1]
                )
                return cons_ops.pack_bases_device(cons), cl
            return (cons_ops.pack_votes(v) if packed else v), w_len
        v = cons_ops.consensus_votes(
            frags, frag_len, tpl, tpl_len,
            S=S_local,
            min_column_support=min_column_support,
            scoring=scoring,
            frag_d0=frag_d0,
            axis_name=axis_name,
        )
        return cons_ops.pack_votes(v) if packed else v

    in_specs = [
        P("data", frag, None),   # frags
        P("data", frag),         # frag_len
        P("data", None),         # tpl (replicated over frag)
        P("data"),               # tpl_len
    ]
    if with_d0:
        in_specs.append(P("data", frag))
    if packed:
        out_specs = cons_ops.PackedVotes(
            col_base=P("data", None),
            col_del=P("data", None),
            ins_len=P("data", None),
            ins_pack=P("data", None),
            pre_len=P("data"),
            pre_pack=P("data"),
            suf_len=P("data"),
            suf_pack=P("data"),
        )
    else:
        out_specs = cons_ops.WindowVotes(
            col_base=P("data", None),
            col_del=P("data", None),
            ins_len=P("data", None),
            ins_base=P("data", None, None),
            coverage=P("data", None),
            n_matched=P("data", None),
            pre_len=P("data"),
            pre_base=P("data", None),
            suf_len=P("data"),
            suf_base=P("data", None),
        )
    if assemble_out:
        out_specs = (P("data", None), P("data"))
    elif rounds > 1:
        out_specs = (out_specs, P("data"))
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _sharded_wire_fn(mesh, S, Pb, Lt, min_column_support, scoring,
                     rounds, assemble_out=False, warm_frac=1.0):
    def body(buf):
        return cons_ops.consensus_votes_wire(
            buf, S=S, Pb=Pb, Lt=Lt,
            min_column_support=min_column_support, scoring=scoring,
            rounds=rounds, assemble_out=assemble_out,
            warm_frac=warm_frac,
        )

    fn = jax.shard_map(
        body, mesh=mesh, in_specs=(P("data", None),),
        out_specs=P("data", None), check_vma=False,
    )
    return jax.jit(fn)


def sharded_wire_step(mesh, buf, *, S, Pb, Lt, min_column_support,
                      scoring, rounds=1, assemble_out=False,
                      warm_frac=1.0):
    """Wire-format consensus step sharded over the `data` mesh axis
    (the engine's production path: one upload + one download buffer
    per call, split over all local devices; all refinement rounds
    fused into the one dispatch, and with assemble_out the download
    is just the packed assembled consensus)."""
    fn = _sharded_wire_fn(mesh, S, Pb, Lt, min_column_support, scoring,
                          rounds, assemble_out, warm_frac)
    return fn(jax.device_put(buf, NamedSharding(mesh, P("data", None))))


def sharded_consensus_step(
    mesh: Mesh,
    frags,
    frag_len,
    tpl,
    tpl_len,
    *,
    S: int,
    min_column_support: int = 2,
    scoring: align_ops.Scoring = align_ops.Scoring(),
    frag_d0=None,
    packed: bool = False,
    frags_packed: bool = False,
    rounds: int = 1,
    assemble_out: bool = False,
    warm_frac: float = 1.0,
):
    """One device-parallel consensus step: window batch split over
    `data`, fragment slots over `frag` (vote reductions become
    all-reduces over `frag`).  Inputs are host or device arrays with
    leading dim B divisible by the data-axis size (and S by the frag
    size).  packed=True returns the wire-format PackedVotes; with
    rounds > 1 the refinement rounds are device-fused and the result
    is (votes, final template lengths); assemble_out=True returns the
    2-bit-packed assembled consensus + lengths instead of votes."""
    fn = sharded_votes_fn(
        mesh, S, min_column_support, scoring, frag_d0 is not None,
        packed, frags_packed, rounds, assemble_out, warm_frac,
    )
    axes = dict(zip(mesh.axis_names, mesh.devices.shape))
    frag = "frag" if axes.get("frag", 1) > 1 else None
    specs = [P("data", frag, None), P("data", frag), P("data", None),
             P("data")]
    args = [frags, frag_len, tpl, tpl_len]
    if frag_d0 is not None:
        specs.append(P("data", frag))
        args.append(frag_d0)
    args = put_batch(mesh, args, specs)
    return fn(*args)
