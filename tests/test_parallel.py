"""Sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from consent_jax.ops import consensus as cons_ops
from consent_jax.parallel import mesh as mesh_mod


def _inputs(B, S, Lf, W, seed=0):
    rng = np.random.default_rng(seed)
    tpl = rng.integers(0, 4, (B, W)).astype(np.uint8)
    frags = np.zeros((B, S, Lf), dtype=np.uint8)
    frag_len = np.zeros((B, S), dtype=np.int32)
    for b in range(B):
        for s in range(S):
            L = W - int(rng.integers(0, 8))
            f = tpl[b, :L].copy()
            pos = rng.integers(0, L, max(1, L // 12))
            f[pos] = (f[pos] + 1) % 4
            frags[b, s, :L] = f
            frag_len[b, s] = L
    return (
        jnp.asarray(frags), jnp.asarray(frag_len),
        jnp.asarray(tpl), jnp.asarray(np.full(B, W, np.int32)),
    )


def test_eight_virtual_devices_present():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("frag_axis", [1, 2, 4])
def test_sharded_consensus_matches_single_device(frag_axis):
    B, S, Lf, W = 8, 8, 64, 64
    args = _inputs(B, S, Lf, W)
    ref = cons_ops.consensus_votes(*args, S=S, min_column_support=2)

    m = mesh_mod.make_mesh(8, frag_axis=frag_axis)
    out = mesh_mod.sharded_consensus_step(m, *args, S=S)
    for a, b in zip(ref, out):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_graft_entry_compiles():
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert out.col_base.shape[0] == args[0].shape[0]


def test_graft_dryrun_multichip():
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)
