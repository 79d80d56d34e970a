"""The GPU aligner's wrapper and recurrence vs the XLA posterior scan.

The CUDA kernel has no interpret mode, so on the CPU the wrapper
(ops/gpu_align.py) runs against the kernel's host model
(ops/cuda/align_host.cc: the same slot geometry and cell arithmetic,
bound to the same FFI target for the CPU platform).  Every case must
equal ops/align.py posterior_summary bit for bit in all six fields.
The `gpu`-marked tests at the end run the compiled kernel on a card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from consent_jax.ops import align as align_ops
from consent_jax.ops import gpu_align
from consent_jax.pipeline import device_align

# the production stitch scoring (pipeline/stitch.py STITCH_SCORING)
STITCH = device_align._SCORING


def pad_to(x, L):
    out = np.zeros(L, dtype=np.uint8)
    out[: len(x)] = x
    return out


def lanes(qs, rs, Lq, Lr):
    q = jnp.array([pad_to(x, Lq) for x in qs])
    ql = jnp.array([len(x) for x in qs], jnp.int32)
    r = jnp.array([pad_to(x, Lr) for x in rs])
    rl = jnp.array([len(x) for x in rs], jnp.int32)
    return q, ql, r, rl


def both(qs, rs, Lq, Lr, sc=align_ops.Scoring(), d0s=None):
    q, ql, r, rl = lanes(qs, rs, Lq, Lr)
    d0 = None if d0s is None else jnp.array(d0s, jnp.int32)
    a = align_ops.posterior_summary(q, ql, r, rl, sc, d0=d0)
    b = gpu_align.posterior_summary(q, ql, r, rl, sc, d0=d0)
    return a, b


def assert_summaries_equal(a, b):
    for field in a._fields:
        x, y = np.asarray(getattr(a, field)), np.asarray(getattr(b, field))
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)


def random_pair(rng, n=40, mut=0.15):
    true = rng.integers(0, 4, n).astype(np.uint8)
    q = []
    for bse in true:
        p = rng.random()
        if p < mut / 3:
            continue
        elif p < 2 * mut / 3:
            q.append(rng.integers(0, 4))
        elif p < mut:
            q.extend([bse, rng.integers(0, 4)])
        else:
            q.append(bse)
    return np.array(q, dtype=np.uint8), true


def near_diagonal(rng, n_lanes, Lq, Lr, d0_range):
    qs, rs, d0s = [], [], []
    for _ in range(n_lanes):
        ref = rng.integers(0, 4, Lr).astype(np.uint8)
        d0 = int(rng.integers(*d0_range))
        L = int(rng.integers(30, Lq))
        src = np.clip(np.arange(L) + d0, 0, Lr - 1)
        frag = ref[src].copy()
        pos = rng.integers(0, L, max(1, L // 8))
        frag[pos] = (frag[pos] + 1 + rng.integers(0, 3, len(pos))) % 4
        qs.append(frag)
        rs.append(ref[: int(rng.integers(Lr // 2, Lr + 1))])
        d0s.append(d0)
    return qs, rs, d0s


@pytest.mark.parametrize("sc", [align_ops.Scoring(), STITCH],
                         ids=["default", "stitch"])
@pytest.mark.parametrize("seed", range(6))
def test_full_dp_matches_xla_summary(seed, sc):
    rng = np.random.default_rng(seed)
    pairs = [random_pair(rng, n=int(rng.integers(20, 100))) for _ in range(5)]
    a, b = both([p[0] for p in pairs], [p[1] for p in pairs], 160, 128, sc)
    assert_summaries_equal(a, b)


@pytest.mark.parametrize("max_hgap", [0, 16])
def test_full_dp_wider_than_register_rows(max_hgap):
    """A stitch at --windowSize 1000 pins its rows to 1152 slots, past
    the register variants (1024): the wrapper must accept the width."""
    rng = np.random.default_rng(1152 + max_hgap)
    pairs = [random_pair(rng, n=int(rng.integers(1000, 1152)), mut=0.1)
             for _ in range(2)]
    sc = STITCH._replace(max_hgap=max_hgap)
    a, b = both([p[0][:200] for p in pairs], [p[1] for p in pairs],
                256, 1152, sc)
    assert_summaries_equal(a, b)


def test_full_dp_empty_and_degenerate_lanes():
    qs = [np.empty(0, np.uint8), np.array([0, 1, 2, 3], np.uint8),
          np.array([3, 3, 3], np.uint8)]
    rs = [np.array([0, 1], np.uint8), np.array([0, 1, 2, 3], np.uint8),
          np.empty(0, np.uint8)]
    a, b = both(qs, rs, 128, 128)
    assert_summaries_equal(a, b)


def test_odd_lane_count():
    # N=3: the grid's last block is partly empty
    rng = np.random.default_rng(42)
    pairs = [random_pair(rng, n=60) for _ in range(3)]
    a, b = both([p[0] for p in pairs], [p[1] for p in pairs], 128, 128)
    assert_summaries_equal(a, b)


@pytest.mark.parametrize("Lr", [100, 200, 640])
def test_full_dp_ref_width_padded_to_slots(Lr):
    """Full DP pads the slot count to a multiple of 128; the extra
    slots are out-of-ref cells and change nothing."""
    rng = np.random.default_rng(Lr)
    pairs = [random_pair(rng, n=int(rng.integers(Lr // 2, Lr)))
             for _ in range(3)]
    a, b = both([p[0][: 120] for p in pairs], [p[1] for p in pairs],
                128, Lr)
    assert_summaries_equal(a, b)


@pytest.mark.parametrize("max_hgap", [1, 3, 16])
def test_full_dp_gap_cap(max_hgap):
    rng = np.random.default_rng(7 + max_hgap)
    pairs = [random_pair(rng, n=90, mut=0.3) for _ in range(4)]
    a, b = both([p[0] for p in pairs], [p[1] for p in pairs], 160, 128,
                align_ops.Scoring(max_hgap=max_hgap))
    assert_summaries_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("band", [128, 256])
def test_banded_matches_banded_xla(seed, band):
    """Banded kernel == banded XLA scan, bit for bit, including
    negative / large diagonal offsets and ragged lengths."""
    rng = np.random.default_rng(seed)
    qs, rs, d0s = near_diagonal(rng, 5, 192, 256, (-40, 100))
    sc = align_ops.Scoring(max_hgap=16, band=band)
    a, b = both(qs, rs, 192, 256, sc, d0s)
    assert_summaries_equal(a, b)


@pytest.mark.parametrize("max_hgap", [0, 5, 32])
def test_banded_gap_windows(max_hgap):
    rng = np.random.default_rng(100 + max_hgap)
    qs, rs, d0s = near_diagonal(rng, 4, 160, 320, (-20, 60))
    sc = align_ops.Scoring(max_hgap=max_hgap, band=128)
    a, b = both(qs, rs, 160, 320, sc, d0s)
    assert_summaries_equal(a, b)


def test_banded_degenerate_lanes():
    qs = [np.empty(0, np.uint8), np.array([0, 1, 2, 3], np.uint8),
          np.array([1, 2, 3, 0, 1, 2, 3, 1, 2], np.uint8)]
    rs = [np.array([0, 1], np.uint8), np.array([0, 1, 2, 3], np.uint8),
          np.array([2, 2], np.uint8)]
    a, b = both(qs, rs, 128, 128, align_ops.Scoring(band=128), [0, -3, 200])
    assert_summaries_equal(a, b)


@pytest.mark.parametrize("d0", [-300, -64, 63, 250, 10 ** 6])
def test_banded_far_offsets(d0):
    """Offsets that put part or all of the band off the ref."""
    rng = np.random.default_rng(abs(d0) % 97)
    ref = rng.integers(0, 4, 256).astype(np.uint8)
    frag = ref[np.clip(np.arange(150) + min(d0, 200), 0, 255)]
    a, b = both([frag, frag[::-1].copy()], [ref, ref[:100]], 160, 256,
                align_ops.Scoring(max_hgap=16, band=128), [d0, d0 // 2])
    assert_summaries_equal(a, b)


def test_banded_equals_full_on_near_diagonal_data():
    """With fragments whose true offset is inside the band, the banded
    DP finds the same optimum as the full DP (matched sets may differ
    only on tied off-band paths)."""
    rng = np.random.default_rng(11)
    Lq = Lr = 256
    qs, rs, d0s = [], [], []
    for k in range(8):
        ref = rng.integers(0, 4, Lr).astype(np.uint8)
        d0 = int(rng.integers(-16, 48))
        L = Lq - 40
        src = np.clip(np.arange(L) + d0, 0, Lr - 1)
        frag = ref[src].copy()
        pos = rng.integers(0, L, L // 10)
        frag[pos] = (frag[pos] + 1 + rng.integers(0, 3, len(pos))) % 4
        qs.append(frag)
        rs.append(ref)
        d0s.append(d0)
    q, ql, r, rl = lanes(qs, rs, Lq, Lr)
    full = align_ops.posterior_summary(
        q, ql, r, rl, align_ops.Scoring(max_hgap=16)
    )
    band = align_ops.posterior_summary(
        q, ql, r, rl, align_ops.Scoring(max_hgap=16, band=128),
        d0=jnp.array(d0s, jnp.int32),
    )
    np.testing.assert_array_equal(np.asarray(full.opt), np.asarray(band.opt))
    agree = (np.asarray(full.matched) == np.asarray(band.matched)).mean()
    assert agree > 0.99


def test_wrapper_jits_and_keeps_shapes():
    rng = np.random.default_rng(5)
    pairs = [random_pair(rng, n=50) for _ in range(6)]
    q, ql, r, rl = lanes([p[0] for p in pairs], [p[1] for p in pairs],
                         96, 70)
    sc = align_ops.Scoring(max_hgap=16)
    out = jax.jit(gpu_align.posterior_summary, static_argnames="sc")(
        q, ql, r, rl, sc=sc)
    assert out.opt.shape == (6,) and out.matched.shape == (6, 70)
    assert out.matched.dtype == jnp.bool_
    assert_summaries_equal(align_ops.posterior_summary(q, ql, r, rl, sc), out)


@pytest.mark.parametrize("max_hgap,Lr,S,want", [
    (0, 640, 640, 0),      # exact stitch scoring
    (16, 640, 128, 16),    # consensus cap inside the band
    (17, 640, 128, 32),    # next power of two, as the XLA doubling
    (1, 640, 128, 1),
    (100, 640, 128, 0),    # window covers the band: unbounded
    (700, 640, 640, 0),    # cap not below the ref width
])
def test_gap_window(max_hgap, Lr, S, want):
    assert gpu_align.gap_window(max_hgap, Lr, S) == want


def test_gap_window_matches_xla_prefix_scan():
    """The window gap_window() names is the one the XLA doubling scan
    realises."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.integers(-50, 50, (1, 64)), jnp.int32)
    for g in (1, 2, 3, 5, 16, 40):
        w = gpu_align.gap_window(g, 64, 64) or 64
        got = np.asarray(align_ops._prefix_max_exclusive(x, 1, g))[0]
        xs = np.asarray(x)[0]
        want = [max(xs[max(0, s - w):s], default=align_ops.NEG)
                for s in range(64)]
        np.testing.assert_array_equal(got, want)


def test_slot_count():
    assert gpu_align.slot_count(640, 0) == 640
    assert gpu_align.slot_count(600, 0) == 640
    assert gpu_align.slot_count(5, 0) == 128
    assert gpu_align.slot_count(640, 128) == 128


@pytest.mark.parametrize("Lr", [640, 1152, 4096])
def test_check_accepts_every_stitch_width(Lr):
    gpu_align.check(Lr, Lr, STITCH, platform="cpu")


def test_check_refuses_wide_queries():
    with pytest.raises(ValueError, match="int16"):
        gpu_align.check(2 ** 15, 640, STITCH, platform="cpu")


def test_aligners_check_shapes_at_set_up(monkeypatch):
    """On the kernel backend the consensus engine and the stitch aligner
    ask gpu_align.check() for their pinned shapes when they are built."""
    from consent_jax.config import correct_preset
    from consent_jax.pipeline import engine

    calls = []
    monkeypatch.setattr(gpu_align, "check",
                        lambda Lq, Lr, sc: calls.append((Lq, Lr, sc)))
    monkeypatch.setattr(engine, "align_backend", lambda: "cuda")
    monkeypatch.setattr(align_ops, "backend", lambda: "cuda")
    cfg = correct_preset(window_size=1000, n_devices=1)
    eng = engine.ConsensusEngine(cfg)
    device_align.FixedAligner(cfg)
    assert calls == [
        (1024, 1152, eng.scoring),
        (1152, 1152, STITCH),
    ]


def test_unsupported_band_raises():
    q, ql, r, rl = lanes([np.zeros(4, np.uint8)], [np.zeros(4, np.uint8)],
                         8, 8)
    with pytest.raises(ValueError):
        gpu_align.posterior_summary(q, ql, r, rl,
                                    align_ops.Scoring(band=100))


@pytest.mark.parametrize("platform,want", [("gpu", "cuda"), ("cpu", "xla")])
def test_backend_decision(platform, want):
    assert align_ops.backend(platform) == want


def test_backend_refuses_unknown_platform():
    with pytest.raises(RuntimeError):
        align_ops.backend("metal")


def test_summary_runs_xla_on_cpu(monkeypatch):
    """On the CPU the dispatcher never reaches the FFI wrapper."""
    def boom(*a, **k):
        raise AssertionError("GPU wrapper called on the CPU")

    monkeypatch.setattr(gpu_align, "posterior_summary", boom)
    rng = np.random.default_rng(1)
    pairs = [random_pair(rng) for _ in range(2)]
    q, ql, r, rl = lanes([p[0] for p in pairs], [p[1] for p in pairs],
                         64, 64)
    assert align_ops.backend() == "xla"
    assert_summaries_equal(align_ops.posterior_summary(q, ql, r, rl),
                           align_ops.summary(q, ql, r, rl))


def _device_case(seed, N, Lq, Lr, d0_spread):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (N, Lq)).astype(np.uint8)
    ql = rng.integers(Lq // 2, Lq + 1, N).astype(np.int32)
    r = rng.integers(0, 4, (N, Lr)).astype(np.uint8)
    rl = rng.integers(Lr // 2, Lr + 1, N).astype(np.int32)
    d0 = rng.integers(-d0_spread, d0_spread + 1, N).astype(np.int32)
    return tuple(jnp.asarray(x) for x in (q, ql, r, rl, d0))


@pytest.mark.gpu
@pytest.mark.parametrize("band,max_hgap,Lr", [
    (128, 16, 640), (0, 0, 640),            # the production variants
    (128, 0, 640), (128, 8, 640), (128, 32, 640), (256, 16, 640),
    (0, 16, 640), (0, 0, 128), (0, 0, 1000),
    # past the register rows: the shared-memory kernel
    (0, 0, 1152), (0, 8, 1280), (0, 16, 1152), (0, 32, 2048),
])
def test_compiled_kernel_matches_xla_on_card(band, max_hgap, Lr):
    q, ql, r, rl, d0 = _device_case(band + Lr, 256, 512, Lr, 16)
    sc = align_ops.Scoring(max_hgap=max_hgap, band=band)
    assert align_ops.backend() == "cuda"
    assert_summaries_equal(
        align_ops.posterior_summary(q, ql, r, rl, sc, d0=d0),
        gpu_align.posterior_summary(q, ql, r, rl, sc, d0=d0),
    )


@pytest.mark.gpu
@pytest.mark.parametrize("L", [640, 1152])
def test_compiled_kernel_at_stitch_scoring_on_card(L):
    """The production stitch scoring on near-identical pairs (long
    optimal paths), at window 500 and window 1000 widths."""
    from consent_jax.testing import simulate

    q, ql, r, rl, d0 = simulate.alignment_lanes(
        256, L, L, d0_range=(-64, 64), error_rate=0.02, seed=L)
    q, ql, r, rl = (jnp.asarray(x) for x in (q, ql, r, rl))
    assert align_ops.backend() == "cuda"
    assert_summaries_equal(
        align_ops.posterior_summary(q, ql, r, rl, STITCH),
        gpu_align.posterior_summary(q, ql, r, rl, STITCH),
    )
