import numpy as np
import pytest

import jax
import jax.numpy as jnp

from consent_jax.io import seqs
from consent_jax.ops import consensus as cons_ops
from consent_jax.ops import kmer as kmer_ops


def make_batch(windows, S, Lf, W):
    """windows: list of (template_str, [frag_str, ...])."""
    B = len(windows)
    frags = np.zeros((B, S, Lf), dtype=np.uint8)
    frag_len = np.zeros((B, S), dtype=np.int32)
    tpl = np.zeros((B, W), dtype=np.uint8)
    tpl_len = np.zeros(B, dtype=np.int32)
    for b, (t, fs) in enumerate(windows):
        tc = seqs.encode(t)
        tpl[b, : len(tc)] = tc
        tpl_len[b] = len(tc)
        for s, fstr in enumerate(fs[:S]):
            fc = seqs.encode(fstr)
            frags[b, s, : len(fc)] = fc
            frag_len[b, s] = len(fc)
    return (
        jnp.array(frags),
        jnp.array(frag_len),
        jnp.array(tpl),
        jnp.array(tpl_len),
    )


def run_consensus(tpl_str, frag_strs, S=8, Lf=64, W=48, min_support=2):
    frags, fl, tpl, tl = make_batch([(tpl_str, frag_strs)], S, Lf, W)
    votes = cons_ops.consensus_votes(
        frags, fl, tpl, tl, S=S, min_column_support=min_support
    )
    codes = cons_ops.assemble_consensus_batch(votes, [len(tpl_str)])[0]
    return seqs.decode(codes)


def test_identical_fragments_reproduce_template():
    t = "ACGTTGCAACGGTTAACC"
    out = run_consensus(t, [t, t, t])
    assert out == t


def test_substitution_corrected_by_majority():
    true = "ACGTTGCAACGGTTAACC"
    tpl = true[:8] + "T" + true[9:]  # one error in template
    out = run_consensus(tpl, [tpl] + [true] * 3)
    assert out == true


def test_deletion_in_template_restored():
    true = "ACGTTGCAACGGTTAACC"
    tpl = true[:9] + true[10:]  # template missing base 9
    out = run_consensus(tpl, [tpl] + [true] * 3)
    assert out == true


def test_insertion_in_template_removed():
    true = "ACGTTGCAACGGTTAACC"
    tpl = true[:9] + "GG" + true[9:]  # template has 2 extra bases
    out = run_consensus(tpl, [tpl] + [true] * 3)
    assert out == true


def test_low_coverage_keeps_template():
    tpl = "ACGTTGCAACGGTTAACC"
    out = run_consensus(tpl, [tpl], min_support=2)
    assert out == tpl


@pytest.mark.parametrize("seed", range(5))
def test_noisy_fragments_recover_truth(seed):
    rng = np.random.default_rng(seed)
    n = 40
    true_codes = rng.integers(0, 4, n).astype(np.uint8)
    true = seqs.decode(true_codes)

    def noisy(rate=0.12):
        out = []
        for b in true_codes:
            p = rng.random()
            if p < rate / 3:
                continue
            elif p < 2 * rate / 3:
                out.append(int(rng.integers(0, 4)))
            elif p < rate:
                out.extend([int(b), int(rng.integers(0, 4))])
            else:
                out.append(int(b))
        return seqs.decode(np.array(out, dtype=np.uint8))

    tpl = noisy()
    frags = [tpl] + [noisy() for _ in range(9)]
    out = run_consensus(tpl, frags, S=10, Lf=64, W=len(tpl))

    def ident(a, b):
        from difflib import SequenceMatcher

        return SequenceMatcher(None, a, b).ratio()

    assert ident(out, true) > ident(tpl, true) or out == true
    assert ident(out, true) > 0.95


def test_count_kmers_device_matches_host():
    rng = np.random.default_rng(3)
    B, S, L, k = 2, 3, 20, 4
    frags = rng.integers(0, 4, (B, S, L)).astype(np.uint8)
    frag_len = np.array([[20, 13, 0], [20, 20, 3]], dtype=np.int32)
    dev = np.asarray(
        kmer_ops.count_kmers_device(jnp.array(frags), jnp.array(frag_len), k=k)
    )
    for b in range(B):
        host = kmer_ops.count_kmers_host(
            [frags[b, s, : frag_len[b, s]] for s in range(S)], k
        )
        assert np.array_equal(dev[b], host), f"window {b}"


def test_solidity_mask_last_kmer_rule():
    # L=6, k=3: mask[p] = solid(kmer starting at min(p, 3))
    cons = seqs.encode("ACGTAC")
    counts = np.zeros(64, dtype=np.int32)
    ks = seqs.kmer_codes(cons, 3)
    counts[ks[0]] = 5   # ACG solid
    counts[ks[3]] = 5   # TAC solid
    mask = kmer_ops.solidity_mask(cons, counts, 3, solid_thresh=4)
    # p=0 -> kmer@0 solid; p=1,2 -> kmers @1,@2 weak; p=3,4,5 -> kmer@3 solid
    assert mask.tolist() == [True, False, False, True, True, True]


def test_template_missing_leading_base_restored():
    true = "ACGTTGCAACGGTTAACC"
    tpl = true[2:]  # template lost its first two bases
    out = run_consensus(tpl, [tpl] + [true] * 3)
    assert out == true


def test_template_missing_trailing_base_restored():
    true = "ACGTTGCAACGGTTAACC"
    tpl = true[:-2]  # template lost its last two bases
    out = run_consensus(tpl, [tpl] + [true] * 3)
    assert out == true


def test_wire_format_roundtrip_matches_unpacked():
    """consensus_votes_wire (single-buffer upload/download) must agree
    with the plain consensus_votes path bit for bit."""
    import jax

    from consent_jax.ops import consensus as cons_ops
    from consent_jax.ops.align import Scoring

    rng = np.random.default_rng(3)
    B, S, Lf, W = 4, 8, 128, 128
    frags = rng.integers(0, 4, (B, S, Lf)).astype(np.uint8)
    frag_len = rng.integers(Lf // 2, Lf + 1, (B, S)).astype(np.int32)
    tpl = rng.integers(0, 4, (B, W)).astype(np.uint8)
    tpl_len = np.full(B, W, np.int32)
    d0 = rng.integers(-4, 5, (B, S)).astype(np.int32)
    sc = Scoring(max_hgap=16, band=128)

    ref = cons_ops.consensus_votes(
        jnp.asarray(frags), jnp.asarray(frag_len), jnp.asarray(tpl),
        jnp.asarray(tpl_len), S=S, min_column_support=2, scoring=sc,
        frag_d0=jnp.asarray(d0),
    )
    ref_cons = cons_ops.assemble_consensus_batch(
        jax.tree.map(np.asarray, ref), tpl_len.tolist()
    )

    packed = cons_ops.pack_bases_host(frags)
    buf = cons_ops.wire_encode_inputs(packed, frag_len, tpl, tpl_len, d0)
    out = cons_ops.consensus_votes_wire(
        jnp.asarray(buf), S=S, Pb=Lf // 4, Lt=W,
        min_column_support=2, scoring=sc,
    )
    votes, w_len = cons_ops.wire_decode_votes(np.asarray(out), W)
    assert np.array_equal(w_len, tpl_len)  # rounds=1: pass-through
    wire_cons = cons_ops.assemble_consensus_batch(votes, w_len.tolist())
    for a, b in zip(ref_cons, wire_cons):
        assert np.array_equal(a, b)


def _random_vote_inputs(seed, B=6, S=8, Lf=128, W=128):
    rng = np.random.default_rng(seed)
    frags = rng.integers(0, 4, (B, S, Lf)).astype(np.uint8)
    frag_len = rng.integers(Lf // 2, Lf + 1, (B, S)).astype(np.int32)
    tpl = rng.integers(0, 4, (B, W)).astype(np.uint8)
    tpl_len = rng.integers(W // 2, W + 1, B).astype(np.int32)
    d0 = rng.integers(-4, 5, (B, S)).astype(np.int32)
    return frags, frag_len, tpl, tpl_len, d0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assemble_template_device_matches_host(seed):
    """Device-side template assembly (the fused-rounds building block)
    must be BIT-equal to the host assemble + truncate-to-Lt chain it
    replaces (engine.py's former between-rounds host round trip)."""
    from consent_jax.ops import consensus as cons_ops
    from consent_jax.ops.align import Scoring

    frags, frag_len, tpl, tpl_len, d0 = _random_vote_inputs(seed)
    B, W = tpl.shape
    Lt = W
    sc = Scoring(max_hgap=16, band=128)
    v = cons_ops.consensus_votes(
        jnp.asarray(frags), jnp.asarray(frag_len), jnp.asarray(tpl),
        jnp.asarray(tpl_len), S=frags.shape[1], min_column_support=2,
        scoring=sc, frag_d0=jnp.asarray(d0),
    )
    host = cons_ops.assemble_consensus_batch(
        jax.tree.map(np.asarray, v), tpl_len.tolist()
    )
    dev_tpl, dev_len = cons_ops.assemble_template_device(
        v, jnp.asarray(tpl_len), Lt
    )
    dev_tpl, dev_len = np.asarray(dev_tpl), np.asarray(dev_len)
    for b in range(B):
        want = host[b][:Lt]
        assert dev_len[b] == len(want), f"window {b}"
        assert np.array_equal(dev_tpl[b, : len(want)], want), f"window {b}"
        assert not dev_tpl[b, len(want):].any()


@pytest.mark.parametrize("rounds", [2, 3])
def test_fused_rounds_match_sequential_host_loop(rounds):
    """consensus_votes_rounds (all rounds in one device computation)
    must reproduce the former engine loop exactly: votes -> host
    assemble -> truncate to Lt -> redispatch as the next template."""
    from consent_jax.ops import consensus as cons_ops
    from consent_jax.ops.align import Scoring

    frags, frag_len, tpl, tpl_len, d0 = _random_vote_inputs(7 + rounds)
    B, W = tpl.shape
    S = frags.shape[1]
    Lt = W
    sc = Scoring(max_hgap=16, band=128)

    def votes_of(t, tl):
        return cons_ops.consensus_votes(
            jnp.asarray(frags), jnp.asarray(frag_len), jnp.asarray(t),
            jnp.asarray(tl), S=S, min_column_support=2, scoring=sc,
            frag_d0=jnp.asarray(d0),
        )

    # sequential reference: the pre-fusion engine flow
    cur_t, cur_l = tpl, tpl_len
    for _ in range(rounds - 1):
        v = votes_of(cur_t, cur_l)
        cons = cons_ops.assemble_consensus_batch(
            jax.tree.map(np.asarray, v), cur_l.tolist()
        )
        nt = np.zeros((B, Lt), np.uint8)
        nl = np.zeros(B, np.int32)
        for b, c in enumerate(cons):
            L = min(len(c), Lt)
            nt[b, :L] = c[:L]
            nl[b] = L
        cur_t, cur_l = nt, nl
    want = jax.tree.map(np.asarray, votes_of(cur_t, cur_l))
    want_cons = cons_ops.assemble_consensus_batch(want, cur_l.tolist())

    got, w_len = cons_ops.consensus_votes_rounds(
        jnp.asarray(frags), jnp.asarray(frag_len), jnp.asarray(tpl),
        jnp.asarray(tpl_len), S=S, rounds=rounds,
        min_column_support=2, scoring=sc, frag_d0=jnp.asarray(d0),
    )
    assert np.array_equal(np.asarray(w_len), cur_l)
    got_cons = cons_ops.assemble_consensus_batch(
        jax.tree.map(np.asarray, got), np.asarray(w_len).tolist()
    )
    for a, b in zip(want_cons, got_cons):
        assert np.array_equal(a, b)


def test_run_conservation_restores_homopolymer_indels():
    """Indels inside equal-base runs are invisible to per-column votes
    (every run column is matched on some optimal path); the
    run-conservation votes must fix both directions."""
    truth = seqs.encode("ACGTCCCCAGTTGGGGACTAAAATTGC" * 6)
    # template missing one C of the CCCC run and with an extra T
    tpl_s = "ACGTCCCAGTTGGGGACTAAAATTGC" + "ACGTCCCCAGTTTGGGGACTAAAATTGC" \
        + "ACGTCCCCAGTTGGGGACTAAAATTGC" * 4
    tpl = seqs.encode(tpl_s)
    B, S = 1, 8
    W = 256
    frags = np.zeros((B, S, W), np.uint8)
    flen = np.zeros((B, S), np.int32)
    for s in range(S):
        frags[0, s, : len(truth)] = truth[:W]
        flen[0, s] = min(len(truth), W)
    tp = np.zeros((B, W), np.uint8)
    tp[0, : len(tpl)] = tpl[:W]
    tlen = np.array([min(len(tpl), W)], np.int32)

    from consent_jax.ops import consensus as cons_ops

    votes = cons_ops.consensus_votes(
        jnp.asarray(frags), jnp.asarray(flen), jnp.asarray(tp),
        jnp.asarray(tlen), S=S, min_column_support=2,
    )
    import jax

    cons = cons_ops.assemble_consensus_batch(
        jax.tree.map(np.asarray, votes), tlen.tolist()
    )[0]
    assert seqs.decode(cons) == seqs.decode(truth[: len(cons)])


@pytest.mark.parametrize("rounds", [1, 2])
def test_wire_assemble_out_matches_host_assembly(rounds):
    """The production assemble_out wire (device-assembled, 2-bit
    packed consensus download) must equal host-assembling the votes
    wire and truncating to Lt."""
    from consent_jax.ops import consensus as cons_ops
    from consent_jax.ops.align import Scoring

    frags, frag_len, tpl, tpl_len, d0 = _random_vote_inputs(31 + rounds)
    B, W = tpl.shape
    S = frags.shape[1]
    sc = Scoring(max_hgap=16, band=128)
    packed = cons_ops.pack_bases_host(frags)
    buf = cons_ops.wire_encode_inputs(packed, frag_len, tpl, tpl_len, d0)

    out_votes = cons_ops.consensus_votes_wire(
        jnp.asarray(buf), S=S, Pb=frags.shape[2] // 4, Lt=W,
        min_column_support=2, scoring=sc, rounds=rounds,
    )
    votes, w_len = cons_ops.wire_decode_votes(np.asarray(out_votes), W)
    want = [
        c[:W]
        for c in cons_ops.assemble_consensus_batch(votes, w_len.tolist())
    ]

    out_cons = cons_ops.consensus_votes_wire(
        jnp.asarray(buf), S=S, Pb=frags.shape[2] // 4, Lt=W,
        min_column_support=2, scoring=sc, rounds=rounds,
        assemble_out=True,
    )
    got = cons_ops.wire_decode_cons(np.asarray(out_cons), W)
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), f"window {b}"
