"""Auxiliary subsystems: observability, multi-host sharding,
checkpoint/resume."""

import io
import json

import numpy as np
import pytest

from consent_jax.io.paf import OVERLAP_DTYPE, Pile
from consent_jax.parallel import multihost
from consent_jax.pipeline.checkpoint import ChunkStore
from consent_jax.utils.observe import StageStats


def make_piles(n):
    out = []
    for i in range(n):
        ov = np.array(
            [(100, 0, 99, False, 100, 0, 99, 50, 100, 255)],
            dtype=OVERLAP_DTYPE,
        )
        out.append(Pile(q_name=f"r{i}", t_names=["t"], ov=ov))
    return out


def test_stage_stats():
    st = StageStats()
    with st.timer("consensus", n=5):
        pass
    st.add("windows", 7)
    snap = st.snapshot()
    assert snap["counts"]["consensus"] == 5
    assert snap["counts"]["windows"] == 7
    buf = io.StringIO()
    st.report(file=buf)
    out = json.loads(buf.getvalue())
    assert "consent_jax_stats" in out


def test_shard_piles_partition():
    piles = make_piles(10)
    shards = [
        [p.q_name for p in multihost.shard_piles(piles, i, 3)]
        for i in range(3)
    ]
    # disjoint, complete, round-robin
    all_names = sorted(n for s in shards for n in s)
    assert all_names == sorted(p.q_name for p in piles)
    assert shards[0] == ["r0", "r3", "r6", "r9"]


def test_merge_shards_restores_order(tmp_path):
    base = str(tmp_path / "out.fasta")
    # two shards with ordinal-tagged records
    with open(multihost.shard_path(base, 0), "w") as f:
        f.write(">a #0\nAAAA\n>c #2\nCCCC\n")
    with open(multihost.shard_path(base, 1), "w") as f:
        f.write(">b #1\nGGGG\n")
    out = str(tmp_path / "merged.fasta")
    multihost.merge_shards(base, 2, out)
    assert open(out).read() == ">a\nAAAA\n>b\nGGGG\n>c\nCCCC\n"


def test_chunk_store_resume(tmp_path):
    out = str(tmp_path / "corrected.fasta")
    store = ChunkStore(out)
    store.write_chunk(0, [("r0", "ACGT"), ("r1", "GGTT")])
    store.write_chunk(1, [("r2", "TTAA")])
    assert store.n_complete_prefix() == 2

    # a new store over the same dir resumes
    store2 = ChunkStore(out)
    assert store2.is_done(0) and store2.is_done(1)
    assert not store2.is_done(2)
    store2.write_chunk(2, [("r3", "CCGG")])
    n = store2.assemble(out)
    assert n == 4
    text = open(out).read()
    assert text.index(">r0") < text.index(">r2") < text.index(">r3")


def test_chunk_store_gap_stops_assembly(tmp_path):
    out = str(tmp_path / "o.fasta")
    store = ChunkStore(out)
    store.write_chunk(0, [("a", "AA")])
    store.write_chunk(2, [("c", "CC")])  # gap at 1
    assert store.n_complete_prefix() == 1
    assert store.assemble(out) == 1


def test_init_distributed_without_cluster_env(monkeypatch):
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("JAX_PROCESS_COUNT", raising=False)
    assert multihost.init_distributed() == (0, 1)


@pytest.mark.parametrize("var,value", [
    ("COORDINATOR_ADDRESS", "localhost:1"),
    ("JAX_PROCESS_COUNT", "2"),
])
def test_init_distributed_raises_on_failure(monkeypatch, var, value):
    """A cluster that cannot be joined is an error, not a silent
    single-host run."""
    import jax

    calls = []

    def fail(*args, **kw):
        calls.append((args, kw))
        raise RuntimeError("coordinator unreachable")

    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("JAX_PROCESS_COUNT", raising=False)
    monkeypatch.setenv(var, value)
    monkeypatch.setattr(jax.distributed, "initialize", fail)
    with pytest.raises(RuntimeError, match="unreachable"):
        multihost.init_distributed()
    assert calls == [((), {})]


_CACHE_PROBE = """
import os, jax, jax.numpy as jnp
from consent_jax.utils import jaxcache
jaxcache.enable()
print(jax.config.jax_compilation_cache_dir)
jax.jit(lambda x: x * 3 + 1)(jnp.arange(7)).block_until_ready()
"""


def _cache_probe(env):
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "JAX_PLATFORMS": "cpu", **env}
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], cwd=root,
                         env=env, capture_output=True, text=True,
                         check=True)
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_honours_env_dir(tmp_path):
    cache = tmp_path / "jaxcache"
    cache.mkdir()
    assert _cache_probe({"JAX_COMPILATION_CACHE_DIR": str(cache)}) == str(cache)
    assert any(cache.iterdir()), "nothing cached in JAX_COMPILATION_CACHE_DIR"


def test_compile_cache_default_is_checkout_dir(monkeypatch):
    from consent_jax.utils import jaxcache

    env = {"JAX_COMPILATION_CACHE_DIR": ""}
    assert _cache_probe(env) == jaxcache.DEFAULT_DIR
    assert jaxcache.DEFAULT_DIR.endswith(".jax_cache")
