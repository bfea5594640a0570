"""The port's delay model and planners (repro_torch.core.delay) against the
JAX package's on parameter grids.  Both are float64 numpy over the same
formulas in the same order, so every output is compared exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import delay as jd  # noqa: E402
from repro_torch.core import delay as td  # noqa: E402

# the paper's Fig. 4 parameter set (reference tests/test_delay.py)
PAPER = dict(C=0.5, K=3, delta=1.0 / 300, t_total=1.0, t_lp=4e-5, t_cp=3e-5)


def levels(mod, *specs):
    return [mod.FixedLevel(f"depth{i}", k, d, lat)
            for i, (k, d, lat) in enumerate(specs)]


def test_eq9_to_11_scalars_on_a_grid():
    for H in (0, 1, 7, 64, 1000, 10**6):
        for t_delay in (0.0, 1e-4, 0.4):
            assert td.rounds_for_budget(1.0, H, 4e-5, t_delay, 3e-5) == \
                jd.rounds_for_budget(1.0, H, 4e-5, t_delay, 3e-5)
        for C, K in ((0.5, 3), (2.0, 4), (1.0, 1)):
            for delta in (1e-3, 1 / 300, 0.1):
                for acc in (0.0, 0.5, 1.0):
                    assert td.per_round_factor(H, C, K, delta, acc) == \
                        jd.per_round_factor(H, C, K, delta, acc)
                    kw = dict(C=C, K=K, delta=delta, t_total=2.0, t_lp=1e-5,
                              t_delay=1e-3, t_cp=1e-5, acceleration=acc)
                    assert td.log_bound(H, **kw) == jd.log_bound(H, **kw)


@pytest.mark.parametrize("t_delay", [0.0, 4e-4, 0.04, 4.0])
@pytest.mark.parametrize("acc", [0.0, 0.7])
def test_optimal_h_matches(t_delay, acc):
    kw = dict(PAPER, t_delay=t_delay, h_max=10**5, acceleration=acc)
    assert td.optimal_h(**kw) == jd.optimal_h(**kw)


def test_optimal_h_vs_delay_and_validation_match():
    rs = [0, 10, 1e3, 1e5]
    np.testing.assert_array_equal(td.optimal_h_vs_delay(rs, **PAPER),
                                  jd.optimal_h_vs_delay(rs, **PAPER))
    for bad in ({"C": 4.0}, {"C": 0.0}):
        with pytest.raises(ValueError, match="0 < C <= K"):
            td.optimal_h(t_delay=0.1, **{**PAPER, **bad})
    with pytest.raises(ValueError, match="acceleration"):
        td.per_round_factor(4, 0.5, 3, 0.01, acceleration=1.5)


def test_link_and_level_models_match():
    for lat, bw in ((1e-5, 50e9), (1e-3, 6.25e9), (0.0, 1e9)):
        a, b = td.LinkModel("l", lat, bw), jd.LinkModel("l", lat, bw)
        for msg in (0.0, 4e3, 4e6):
            assert a.delay(msg) == b.delay(msg)
            for n in (1, 2, 16):
                assert td.ring_allreduce_delay(a, msg, n) == \
                    jd.ring_allreduce_delay(b, msg, n)
                sa, sb = td.SyncLevel("s", n, a, msg), jd.SyncLevel("s", n, b,
                                                                    msg)
                for r in (1.0, 0.28125, 0.02):
                    assert sa.round_delay(r) == sb.round_delay(r)
    for delay, lat in ((0.05, 0.0), (0.05, 0.01), (1e-4, 1e-4)):
        for r in (1.0, 0.28125, 0.5):
            assert td.FixedLevel("f", 4, delay, lat).round_delay(r) == \
                jd.FixedLevel("f", 4, delay, lat).round_delay(r)


PLAN_CASES = {
    "two_level": ((4, 1e-4, 0.0), (2, 0.05, 0.0)),
    "three_level": ((8, 1e-5, 0.0), (4, 1e-3, 1e-4), (2, 0.5, 0.0)),
    "star": ((16, 0.01, 0.0),),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
@pytest.mark.parametrize("opts", [
    {}, {"h_max0": 64}, {"acceleration": 0.5},
    {"compression": "auto"}, {"compression": ["int8", "topk_0.1"]}])
def test_plan_hierarchical_h_and_choose_compression_match(case, opts):
    spec = PLAN_CASES[case]
    kw = dict(C=0.5, delta=1.0 / 256, t_total=10.0, t_lp=1e-6, t_cp=2e-5,
              h_max=10**5)
    opts = dict(opts)
    if opts.get("compression") == "auto":
        rows = td.choose_compression(levels(td, *spec), **kw)
        assert rows == jd.choose_compression(levels(jd, *spec), **kw)
        opts["compression"] = [r["spec"] for r in rows]
    got = td.plan_hierarchical_h(levels(td, *spec), **kw, **opts)
    assert got == jd.plan_hierarchical_h(levels(jd, *spec), **kw, **opts)


def test_choose_compression_candidates_and_validation_match():
    spec = PLAN_CASES["two_level"]
    kw = dict(C=0.5, delta=0.01, t_total=10.0, t_lp=1e-6)
    for cands in (("none",), ("none", "int8"), ("topk_0.05", "int8")):
        assert td.choose_compression(levels(td, *spec), candidates=cands,
                                     **kw) == \
            jd.choose_compression(levels(jd, *spec), candidates=cands, **kw)
    with pytest.raises(ValueError, match="candidate"):
        td.choose_compression(levels(td, *spec), candidates=(), **kw)
    with pytest.raises(ValueError, match="depth1"):
        td.plan_hierarchical_h(levels(td, *spec), C=3.0, delta=0.01,
                               t_total=1.0, t_lp=1e-5)


def test_fit_C_matches():
    gaps = [1.0, 0.5, 0.26, 0.12, 0.07, 0.03]
    hist = [{"gap": g} for g in gaps]
    for K, H, delta, c_max in ((4, 32, 1 / 32, None), (2, 1000, 1e-3, 1.5),
                               (8, 5, 0.1, 2.0)):
        for h in (gaps, hist, gaps[:2], [1.0, 2.0, 3.0]):
            assert td.fit_C(h, K=K, H=H, delta=delta, c_max=c_max) == \
                jd.fit_C(h, K=K, H=H, delta=delta, c_max=c_max)
    with pytest.raises(ValueError, match="two positive"):
        td.fit_C([1.0], K=2, H=4, delta=0.1)


def test_checkpoint_period_matches():
    for t_round in (1e-3, 0.1, 2.0):
        for t_write in (0.0, 0.01, 1.0):
            for mtbf in (10.0, 3600.0):
                for mp in (None, 5):
                    assert td.checkpoint_period(t_round, t_write, mtbf,
                                                max_period=mp) == \
                        jd.checkpoint_period(t_round, t_write, mtbf,
                                             max_period=mp)
    with pytest.raises(ValueError):
        td.checkpoint_period(0.0, 1.0, 1.0)


def test_straggler_model_samples_match():
    base = np.array([1e-3, 2e-3, 5e-2, 1e-4])
    a = td.StragglerModel(slow_prob=0.3, slow_factor=10.0, jitter=0.1)
    b = jd.StragglerModel(slow_prob=0.3, slow_factor=10.0, jitter=0.1)
    ra, rb = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(5):
        np.testing.assert_array_equal(a.sample(base, ra), b.sample(base, rb))
    la, lb = td.LinkModel("l", 1e-3, 1e9), jd.LinkModel("l", 1e-3, 1e9)
    assert td.StragglerModel.for_link(la, 4e6, slow_prob=0.2) == (
        jd.StragglerModel.for_link(lb, 4e6, slow_prob=0.2)[0],
        td.StragglerModel(slow_prob=0.2))
    with pytest.raises(ValueError):
        td.StragglerModel(slow_factor=0.5)


def test_bounded_skip_pair_is_not_ported():
    """The name dates from when the port refused the bounded-skip pair;
    it is ported now (it replays runtime/straggler.py), so the three calls
    the test used to see refused equal the reference's exactly."""
    model = td.StragglerModel()
    jmodel = jd.StragglerModel()
    assert td.simulate_bounded_skip([1e-3] * 4, model, max_consecutive=1) \
        == jd.simulate_bounded_skip([1e-3] * 4, jmodel, max_consecutive=1)
    kw = dict(C=0.5, K=4, delta=0.01, t_total=1.0, t_lp=1e-5, t_cp=0.0,
              base_delays=[1e-3] * 4)
    assert td.optimal_h_bounded_skip(model=model, **kw) == \
        jd.optimal_h_bounded_skip(model=jmodel, **kw)
    plan_kw = dict(C=0.5, delta=0.01, t_total=1.0, t_lp=1e-5)
    assert td.plan_hierarchical_h(levels(td, *PLAN_CASES["star"]),
                                  straggler=model, **plan_kw) == \
        jd.plan_hierarchical_h(levels(jd, *PLAN_CASES["star"]),
                               straggler=jmodel, **plan_kw)
