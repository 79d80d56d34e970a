import numpy as np
import pytest

from consent_jax.config import correct_preset
from consent_jax.core.sparse_counts import SparseCounts
from consent_jax.io import seqs
from consent_jax.ops import kmer as kmer_ops
from consent_jax.pipeline import stitch as st


def cfg_small(**kw):
    base = dict(window_size=20, window_overlap=4, mer_size=5,
                min_support=1, frag_slack=16)
    base.update(kw)
    return correct_preset(**base)


def counts_of(strings, k=5):
    dense = kmer_ops.count_kmers_host([seqs.encode(s) for s in strings], k)
    return SparseCounts.from_dense(dense * 10)


def make_job(raw, windows, cfg, name="r"):
    """windows: list of (pos, consensus_str_or_None, template_str)."""
    piles_pos, consensuses, templates, counts = [], [], [], []
    for pos, cons, tpl in windows:
        piles_pos.append(pos)
        if cons is None:
            consensuses.append((np.empty(0, np.uint8), np.empty(0, bool)))
        else:
            c = seqs.encode(cons)
            consensuses.append((c, np.ones(len(c), dtype=bool)))
        templates.append(seqs.encode(tpl))
        counts.append(counts_of([cons or tpl]))
    return st.StitchJob(name, seqs.encode(raw), piles_pos, consensuses,
                        templates, counts, cfg)


def run_jobs(jobs):
    st.run_stitch(jobs, st.host_batch_align)


def test_single_window_splice():
    cfg = cfg_small()
    raw = "ACGTACGGTTCAGGCATTAC" + "TTTTTT"
    cons = "ACGTACGGTTCAGGCATTAC"  # perfect window consensus
    job = make_job(raw, [((0, 19), cons, raw[0:20])], cfg)
    run_jobs([job])
    codes, solid = job.result()
    out = seqs.decode(codes, solid)
    # window region solid (upper), tail untouched (lower)
    assert out == "ACGTACGGTTCAGGCATTAC" + "tttttt"


def test_single_window_with_correction():
    cfg = cfg_small()
    true = "ACGTACGGTTCAGGCATTAC"
    raw = true[:10] + "A" + true[11:]  # one error in raw read
    job = make_job(raw + "GG", [((0, 19), true, raw[0:20])], cfg)
    run_jobs([job])
    codes, solid = job.result()
    assert seqs.decode(codes, solid) == true + "gg"


def test_short_consensus_falls_back_to_template_not_spliced():
    cfg = cfg_small()
    raw = "ACGTACGGTTCAGGCATTAC"
    # consensus shorter than mer_size: template aligned for bookkeeping
    # but nothing spliced -> output stays lowercase
    job = make_job(raw, [((0, 19), "ACG", raw[0:20])], cfg)
    run_jobs([job])
    codes, solid = job.result()
    assert seqs.decode(codes, solid) == raw.lower()


def test_two_overlapping_windows():
    cfg = cfg_small()
    true = "ACGTACGGTTCAGGCATTACGGATCCAGTTGCAATT"
    raw = true  # error-free raw; windows (0,19) and (16,35)
    job = make_job(
        raw,
        [((0, 19), true[0:20], true[0:20]),
         ((16, 35), true[16:36], true[16:36])],
        cfg,
    )
    run_jobs([job])
    codes, solid = job.result()
    assert seqs.decode(codes, solid) == true
    assert solid.all()


def test_two_windows_disagreeing_overlap_prefers_more_solid():
    cfg = cfg_small()
    true = "ACGTACGGTTCAGGCATTACGGATCCAGTTGCAATT"
    # second window's consensus corrupts the overlap region [16,19]
    w2 = "GGGG" + true[20:36]
    piles_pos = [(0, 19), (16, 35)]
    c1 = seqs.encode(true[0:20])
    c2 = seqs.encode(w2)
    job = st.StitchJob(
        "r", seqs.encode(true), piles_pos,
        [(c1, np.ones(len(c1), bool)), (c2, np.ones(len(c2), bool))],
        [seqs.encode(true[0:20]), seqs.encode(true[16:36])],
        # window 1 counts support its consensus strongly; window 2's
        # counts do NOT contain the corrupted overlap k-mers
        [counts_of([true[0:20]]), counts_of([true[16:36]])],
        cfg,
    )
    run_jobs([job])
    codes, solid = job.result()
    # overlap kept from window 1 (more solid k-mers)
    assert seqs.decode(codes)[:20] == true[:20]


def test_stitch_apply_native_matches_python(monkeypatch):
    """The native stitch_apply_step must be byte-identical to the
    Python apply across random jobs (arbitration branches included)."""
    import numpy as np

    from consent_jax import native
    from consent_jax.config import correct_preset
    from consent_jax.core.sparse_counts import SparseCounts
    from consent_jax.pipeline import stitch as st

    if native.get_lib() is None:
        import pytest
        pytest.skip("native library unavailable")

    rng = np.random.default_rng(9)
    cfg = correct_preset(window_size=64, window_overlap=16)

    def make_jobs():
        jobs = []
        for j in range(12):
            raw = rng.integers(0, 4, int(rng.integers(150, 400))).astype(
                np.uint8
            )
            n_win = int(rng.integers(2, 6))
            pos, cons, tpls, counts = [], [], [], []
            p = 0
            for w in range(n_win):
                beg = p
                end = min(len(raw) - 1, beg + 63)
                pos.append((beg, end))
                p = beg + 48
                piece = raw[beg : end + 1].copy()
                # corrupt some bases so arbitration has disagreements
                if len(piece) > 10:
                    idx = rng.integers(0, len(piece),
                                       max(1, len(piece) // 8))
                    piece[idx] = (piece[idx] + 1) % 4
                # occasionally a too-short consensus (template path)
                if rng.random() < 0.2:
                    cons.append(
                        (piece[:3], np.ones(3, dtype=bool))
                    )
                else:
                    cons.append(
                        (piece,
                         rng.random(len(piece)) < 0.8)
                    )
                tpls.append(raw[beg : end + 1])
                dense = np.zeros(4 ** cfg.mer_size, np.int32)
                km = rng.integers(0, 4 ** cfg.mer_size,
                                  rng.integers(5, 60))
                np.add.at(dense, km, rng.integers(1, 10, len(km)))
                counts.append(SparseCounts.from_dense(dense))
            jobs.append(
                st.StitchJob(
                    name=f"j{j}", raw_codes=raw, piles_pos=pos,
                    consensuses=cons, templates=tpls, counts=counts,
                    cfg=cfg,
                )
            )
        return jobs

    rng = np.random.default_rng(9)
    jobs_a = make_jobs()
    rng = np.random.default_rng(9)
    jobs_b = make_jobs()

    st.run_stitch(jobs_a, st.host_batch_align)  # batched native apply
    # disable the native library entirely: the whole-round batched
    # apply AND the per-window native step fall back to pure Python
    from consent_jax import native as native_mod

    monkeypatch.setattr(native_mod, "get_lib", lambda: None)
    st.run_stitch(jobs_b, st.host_batch_align)  # pure Python path

    for a, b in zip(jobs_a, jobs_b):
        ca, sa = a.result()
        cb, sb = b.result()
        assert np.array_equal(ca, cb), a.name
        assert np.array_equal(sa, sb), a.name
