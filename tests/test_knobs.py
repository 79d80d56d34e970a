"""Every ConsentConfig knob must be live: these tests pin the behavior
of the knobs wired in round 2 (anchor give-up gate, DBG budgets, device
batch geometry, engine device mesh)."""

import dataclasses

import numpy as np
import pytest

from consent_jax import native
from consent_jax.config import ConsentConfig, correct_preset
from consent_jax.core import dbg as dbg_mod
from consent_jax.io.fasta import ReadIndex
from consent_jax.ops import kmer as kmer_ops
from consent_jax.pipeline import engine as eng_mod
from consent_jax.testing import simulate


# ---------------------------------------------------------------------------
# anchor gate (-c/-a: common_kmers / min_anchors)


def test_count_anchors_host_basic():
    rng = np.random.default_rng(0)
    tpl = rng.integers(0, 4, 60).astype(np.uint8)
    # fragments = exact copies: every template k-mer unique in tpl is
    # shared by all sequences
    frags = [tpl, tpl.copy(), tpl.copy()]
    k = 9
    ks = kmer_ops.seqs.kmer_codes(tpl, k)
    uniq, cnt = np.unique(ks, return_counts=True)
    n_unique = int((cnt == 1).sum())
    assert kmer_ops.count_anchors_host(frags, k, 3) == n_unique
    # support above the number of sequences -> no anchors
    assert kmer_ops.count_anchors_host(frags, k, 4) == 0
    # template shorter than k -> no anchors
    assert kmer_ops.count_anchors_host([tpl[:5]], k, 1) == 0


def test_count_anchors_repeated_template_kmer_excluded():
    k = 3
    # template with an internal repeat of one 3-mer (AAA at two spots)
    tpl = np.array([0, 0, 0, 1, 2, 0, 0, 0, 3], np.uint8)
    frags = [tpl, tpl.copy()]
    ks = kmer_ops.seqs.kmer_codes(tpl, k)
    uniq, cnt = np.unique(ks, return_counts=True)
    n_unique = int((cnt == 1).sum())
    got = kmer_ops.count_anchors_host(frags, k, 2)
    assert got == n_unique
    assert got < len(ks)  # the repeated k-mer was excluded


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_count_anchors_native_matches_host(seed):
    if native.get_lib() is None:
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(seed)
    k = 5
    tpl = rng.integers(0, 4, 80).astype(np.uint8)
    frags = [tpl]
    for _ in range(6):
        f = tpl.copy()
        pos = rng.integers(0, len(f), 8)
        f[pos] = (f[pos] + 1) % 4
        frags.append(f[rng.integers(0, 5):])
    for support in (1, 2, 4, 7):
        want = kmer_ops.count_anchors_host(frags, k, support)
        got = native.count_anchors_native(frags, k, support)
        assert got == want, (support, got, want)


def _tiny_engine_run(cfg):
    genome, reads = simulate.simulate(
        genome_len=1200, coverage=10.0, read_len=400,
        error_rate=0.08, seed=7,
    )
    index = ReadIndex()
    for r in reads:
        index.add(r.name, r.codes)
    piles = simulate.piles_from_sim(reads, cfg.max_support)
    return list(eng_mod.process_piles(iter(piles), index, cfg))


def test_min_anchors_gate_falls_back_to_template():
    """An absurd min_anchors makes every window give up: each window's
    consensus is the raw template, so the stitched read equals the raw
    read (template splices reproduce the original bases)."""
    base = correct_preset(
        window_size=128, window_overlap=16, min_support=2,
        consensus_rounds=1,
    )
    gated = dataclasses.replace(base, min_anchors=10**6, trim=False)
    genome, reads = simulate.simulate(
        genome_len=1200, coverage=10.0, read_len=400,
        error_rate=0.08, seed=7,
    )
    index = ReadIndex()
    for r in reads:
        index.add(r.name, r.codes)
    piles = simulate.piles_from_sim(reads, gated.max_support)
    by_name = {r.name: r for r in reads}
    n_checked = 0
    for name, codes, solid in eng_mod.process_piles(
        iter(piles), index, gated
    ):
        if len(codes) == 0:
            continue
        # gave-up windows splice the raw template (substrings of the
        # raw read) back onto the raw read: the output is unchanged
        raw = by_name[name].codes
        assert np.array_equal(codes, raw)
        n_checked += 1
    assert n_checked > 0


# ---------------------------------------------------------------------------
# DBG budgets (max_branches / dbg_zone)


def _decoy_scenario(k=5):
    """A weak gap whose repair needs branch exploration: a decoy branch
    with a higher count dead-ends inside the weak region, so `link`
    must backtrack (costing branch budget) to find the true path."""
    from consent_jax.io import seqs

    true = "TGGTGTTAACCTTACTATACTCCCGCTCCGGGGT"
    decoy = true[8:14] + "GAGGA"  # diverges inside the weak region
    n = 4 ** k
    counts = np.zeros(n, np.int32)
    for s, w in ((true, 10), (decoy, 50)):
        for km in seqs.kmer_codes(seqs.encode(s), k):
            counts[km] += w
    bad = true[:12] + "TTTT" + true[18:]
    codes = seqs.encode(bad)
    solid = np.ones(len(codes), dtype=bool)
    solid[10:22] = False
    truth = seqs.encode(true)
    return truth, codes, solid, counts


def test_max_branches_zero_blocks_branchy_repair():
    k = 5
    truth, codes, solid, counts = _decoy_scenario(k)
    fixed_c, fixed_s = dbg_mod.polish_correction(
        codes, solid, counts, k, 4, max_branches=50, zone=3
    )
    blocked_c, blocked_s = dbg_mod.polish_correction(
        codes, solid, counts, k, 4, max_branches=0, zone=3
    )
    assert np.array_equal(fixed_c, truth)
    assert not np.array_equal(blocked_c, truth)


@pytest.mark.parametrize("zone", [1, 3, 5])
def test_native_polish_matches_python_with_budgets(zone):
    if native.get_lib() is None:
        pytest.skip("native lib unavailable")
    k = 5
    truth, codes, solid, counts = _decoy_scenario(k)
    for mb in (0, 5, 50):
        py_c, py_s = dbg_mod.polish_correction(
            codes, solid, counts, k, 4, max_branches=mb, zone=zone
        )
        nat = native.polish_correction_native(
            codes, solid, counts, k, 4, max_branches=mb, zone=zone
        )
        assert nat is not None
        assert np.array_equal(nat[0], py_c), (mb, zone)
        assert np.array_equal(nat[1], py_s), (mb, zone)


# ---------------------------------------------------------------------------
# device batch geometry + engine mesh


def test_device_lanes_controls_batch_split():
    cfg = correct_preset(device_lanes=8, n_devices=1)
    e = eng_mod.ConsensusEngine(cfg)
    assert e.max_lanes == 8
    cfg2 = correct_preset(device_lanes=8, n_devices=2)
    # capped by available local devices but never below 1
    assert eng_mod.ConsensusEngine(cfg2).max_lanes in (8, 16)


def test_engine_multi_device_matches_single_device():
    """The production engine path (consensus shard_map + sharded stitch
    aligner) must produce byte-identical output on 1 vs 8 devices."""
    outs = {}
    for nd in (1, 8):
        cfg = correct_preset(
            window_size=128, window_overlap=16, min_support=2,
            consensus_rounds=1, n_devices=nd,
        )
        outs[nd] = [
            (name, codes.tobytes(), solid.tobytes())
            for name, codes, solid in _tiny_engine_run(cfg)
        ]
    assert outs[1] == outs[8]


def test_config_validation_rejects_bad_knobs():
    with pytest.raises(ValueError):
        ConsentConfig(device_lanes=0).validate()
    with pytest.raises(ValueError):
        ConsentConfig(max_branches=-1).validate()


def test_engine_frag_axis_matches_single_device():
    """The deep-pile (data, frag) production path: fragment slots
    sharded over `frag` with psum vote reductions must be
    byte-identical to the single-device engine — and it must be the
    path the polish preset auto-selects when fragment demand exceeds
    device_lanes."""
    from consent_jax.config import polish_preset

    outs = {}
    for nd, nf in ((1, 1), (8, 4), (8, None)):
        cfg = polish_preset(
            window_size=128, window_overlap=16, min_support=2,
            consensus_rounds=1, n_devices=nd, frag_devices=nf,
            device_lanes=8,  # < max_msa + 1 -> auto frag axis
        )
        eng = eng_mod.ConsensusEngine(cfg)
        if nf is None and nd == 8:
            assert eng.frag_devices == 8  # auto-selected
        outs[(nd, nf)] = [
            (name, codes.tobytes(), solid.tobytes())
            for name, codes, solid in _tiny_engine_run(cfg)
        ]
    assert outs[(1, 1)] == outs[(8, 4)] == outs[(8, None)]


def test_engine_fused_rounds_device_identity():
    """consensus_rounds=2 runs fused in ONE dispatch (device-side
    between-round assembly); output must be byte-identical on 1 vs 8
    devices AND on the (data, frag) deep-pile mesh."""
    from consent_jax.config import polish_preset

    outs = {}
    cases = (
        ("single", dict(n_devices=1)),
        ("data8", dict(n_devices=8)),
        ("frag", dict(n_devices=8, frag_devices=4, device_lanes=8)),
    )
    for tag, kw in cases:
        cfg = polish_preset(
            window_size=128, window_overlap=16, min_support=2,
            consensus_rounds=2, **kw,
        )
        outs[tag] = [
            (name, codes.tobytes(), solid.tobytes())
            for name, codes, solid in _tiny_engine_run(cfg)
        ]
    assert outs["single"] == outs["data8"] == outs["frag"]
