"""Rehearsal of chip_smoke.py on the CPU: its phase functions at a tiny
size, on the XLA route (the kernel phase runs the GPU wrapper against
its host model).  The script itself refuses to run without a GPU."""

import importlib.util
import os

import pytest

from consent_jax.ops.align import Scoring
from consent_jax.pipeline.device_align import _SCORING as STITCH

_PATH = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
_WINDOWS = ["--windowSize", "200", "--windowOverlap", "20"]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_refuses_cpu(smoke, capsys):
    assert smoke.main([]) == 2
    assert '"ok"' not in capsys.readouterr().out


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(os.path.dirname(_PATH), "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_refuses_cpu(bench, capsys):
    assert bench.main([]) == 2
    assert capsys.readouterr().out == ""


def test_bench_e2e_order_alternates(bench):
    legs = bench.e2e_order(3)
    assert legs[:2] == [("xla", True), ("kernel", True)]
    timed = [name for name, warm in legs[2:] if not warm]
    assert timed == ["xla", "kernel", "kernel", "xla", "xla", "kernel"]


def test_bench_compile_log_counts_compiles(bench):
    import jax
    import jax.numpy as jnp

    log = bench.CompileLog()
    log.take()
    jax.jit(lambda x: x * 3 + 1)(jnp.arange(5)).block_until_ready()
    got = log.take()
    assert got["backend_compiles"] >= 1 and got["backend_compile_s"] > 0
    assert log.take()["backend_compiles"] == 0


def test_devices_phase(smoke):
    info = smoke.phase_devices(require_gpu=False)
    assert info["platform"] == "cpu" and info["count"] == 8
    with pytest.raises(RuntimeError):
        smoke.phase_devices(require_gpu=True)


def test_kernel_phase(smoke):
    shapes = [
        ("consensus", 12, 128, 160, Scoring(max_hgap=16, band=128),
         (-16, 48), 0.10, 0.2),
        ("stitch", 6, 128, 128, STITCH, (-20, 20), 0.02, 0.0),
    ]
    out = smoke.phase_kernel(shapes, reps=1, oracle_lanes=1)
    assert set(out) == {"consensus", "stitch"}


def test_kernel_shapes_are_the_production_calls(smoke):
    """The smoke's kernel shapes carry the scorings and widths the
    engine and the stitcher run with."""
    from consent_jax.config import correct_preset
    from consent_jax.pipeline.device_align import FixedAligner
    from consent_jax.pipeline.engine import ConsensusEngine

    shapes = {s[0]: s for s in smoke._kernel_shapes()}
    eng = ConsensusEngine(correct_preset(n_devices=1))
    assert shapes["consensus"][2:5] == (eng.Lf, eng.Lt, eng.scoring)
    for name, window in (("stitch", 500), ("stitch-w1000", 1000)):
        L = FixedAligner(correct_preset(window_size=window)).fixed_len
        assert shapes[name][2:5] == (L, L, STITCH)


def test_correct_and_polish_phases(smoke, tmp_path):
    genome, reads, reads_fa = smoke.simulate_dataset(
        0.002, str(tmp_path), read_len=700)
    res = smoke.phase_correct(genome, reads, reads_fa, str(tmp_path),
                              extra_argv=_WINDOWS, n_scored=10, floor=0.9)
    assert res["reads_out"] > 0 and res["windows"] > 0
    pol = smoke.phase_polish(genome, reads_fa, str(tmp_path),
                             extra_argv=_WINDOWS, contig_len=1000,
                             draft_error=0.02, n_scored=2)
    assert pol["polished_identity"] > pol["draft_identity"]
    with pytest.raises(AssertionError, match="S=152"):
        smoke.phase_polish(genome, reads_fa, str(tmp_path),
                           extra_argv=_WINDOWS, contig_len=1000,
                           draft_error=0.02, n_scored=1, deepest_bucket=152)


def test_mesh_phases(smoke, tmp_path):
    assert smoke.phase_mesh_votes(B=8, S=16)["votes_equal"]
    res = smoke.phase_mesh_correct(0.002, str(tmp_path), read_len=700,
                                   window=200, overlap=20)
    assert res["fasta_identical"] and res["devices"] == 8
