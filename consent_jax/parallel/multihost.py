"""Multi-host sharding of the pile stream.

The workload is data-parallel at the read/contig level (SURVEY.md §2b):
across hosts, piles are sharded round-robin by pile ordinal; each host
writes its own output shard; shards concatenated in pile order
reproduce the single-host output exactly.  This mirrors the reference's
only cross-worker structure (the explode/merge per-query regrouping,
src/explode.cpp + src/merge.cpp) at host granularity.

No collective is needed for the data path — jax.distributed is only
initialized for device discovery when running on several hosts;
result determinism comes from shard-by-ordinal + ordered merge.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, List, TextIO

from consent_jax.io.paf import Pile


def shard_piles(
    piles: Iterable[Pile], process_index: int, process_count: int
) -> Iterator[Pile]:
    """This host's piles: ordinals i with i % process_count == index."""
    for i, pile in enumerate(piles):
        if i % process_count == process_index:
            yield pile


def shard_path(base: str, process_index: int) -> str:
    return f"{base}.shard{process_index:05d}"


def merge_shards(base: str, process_count: int, out_path: str) -> None:
    """Concatenate per-host FASTA shards back into pile order.

    Each shard holds records tagged with their pile ordinal in the
    header comment (`>name #ordinal`); the merge strips the tag and
    interleaves by ordinal."""
    import heapq
    import re

    streams: List[tuple] = []
    handles: List[TextIO] = []
    for p in range(process_count):
        path = shard_path(base, p)
        try:
            f = open(path)
        except FileNotFoundError:
            for h in handles:
                h.close()
            raise FileNotFoundError(
                f"missing shard {p}/{process_count}: {path} — did "
                f"every host's consent run finish? (each host writes "
                f"its own .shardNNNNN file next to --out)"
            ) from None
        handles.append(f)

    def records(f):
        name = None
        ordinal = None
        seq_lines: List[str] = []
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    yield ordinal, name, "".join(seq_lines)
                head = line[1:]
                name, _, tag = head.rpartition(" #")
                ordinal = int(tag)
                seq_lines = []
            else:
                seq_lines.append(line)
        if name is not None:
            yield ordinal, name, "".join(seq_lines)

    iters = [records(f) for f in handles]
    merged = heapq.merge(*iters, key=lambda r: r[0])
    with open(out_path, "w") as out:
        for ordinal, name, seq in merged:
            out.write(f">{name}\n{seq}\n")
    for f in handles:
        f.close()


def init_distributed() -> tuple:
    """(process_index, process_count) — from jax.distributed when the
    standard cluster env vars are present, else (0, 1).  A failed
    initialization raises: a cluster that cannot be joined is never
    run as a single host."""
    if "JAX_PROCESS_COUNT" in os.environ or "COORDINATOR_ADDRESS" in os.environ:
        import jax

        jax.distributed.initialize()
        return jax.process_index(), jax.process_count()
    return 0, 1
