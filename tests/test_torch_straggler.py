"""Stragglers in the port against the JAX package: the decision classes
of ``runtime/straggler.py`` (exactly: pure host code on the same numpy
generator), the bounded-skip planner of ``core/delay.py`` (exactly), the
straggler-aware ``Schedule.auto`` (exactly), and ``Session.run(
straggler=)`` on the ``"torch"`` backend against the reference's
``vmap`` run (iterates within ``TOL``; participants, ``time``,
``time_sync`` and ``h`` equal).  The non-mesh cases of
``tests/test_straggler.py`` are the targets; small trees throughout."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.api import Problem as JProblem  # noqa: E402
from repro.api import Schedule as JSchedule  # noqa: E402
from repro.api import Session as JSession  # noqa: E402
from repro.api import Topology as JTopology  # noqa: E402
from repro.core import delay as jd  # noqa: E402
from repro.core import dual as JD  # noqa: E402
from repro.core.engine import host as jhost  # noqa: E402
from repro.core.engine import plan as jplan  # noqa: E402
from repro.data.synthetic import gaussian_regression  # noqa: E402
from repro.runtime import straggler as js  # noqa: E402
from repro_torch.api import (Problem, Schedule, Session, Topology,  # noqa: E402
                             convert, solve)
from repro_torch.core import delay as td  # noqa: E402
from repro_torch.core import dual as TD  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.engine import host as thost  # noqa: E402
from repro_torch.core.engine import plan as tplan  # noqa: E402
from repro_torch.runtime import straggler as ts  # noqa: E402

torch.set_num_threads(1)

LAM = 0.1
# a straggler run against the reference's: the same float32 arithmetic in
# two libraries, summed in other orders, over a few rounds of iterates of
# order 1; every integer and host-side quantity -- masks, participants,
# simulated clocks, replanned H -- is equal
TOL = dict(rtol=1e-5, atol=1e-5)

TOPOLOGIES = {
    "star": lambda: JTopology.star(4, 32, rounds=6, local_steps=48,
                                   t_lp=1e-5, t_delay=0.01),
    "two_level": lambda: JTopology.two_level(
        2, 2, 32, root_rounds=12, group_rounds=2, local_steps=32,
        t_lp=1e-5, root_delay=0.02, group_delay=1e-3),
    "imbalanced": lambda: JTopology.groups(
        [[24, 16], [12, 20, 8], 20], root_rounds=5, group_rounds=2,
        local_steps=30, t_lp=1e-5, root_delay=0.02, group_delay=1e-3),
}


def port(topo: JTopology) -> Topology:
    return Topology.from_json(topo.to_json())


def data(m, d=10):
    X, y = gaussian_regression(m=m, d=d)
    return np.array(X), np.array(y)


def models():
    """The same straggler model in both packages."""
    kw = dict(slow_prob=0.3, slow_factor=30.0, jitter=0.02)
    return jd.StragglerModel(**kw), td.StragglerModel(**kw)


# ---------------------------------------------------------------------------
# the decision classes, exactly
# ---------------------------------------------------------------------------
def test_step_timer_equals_the_reference():
    a, b = js.StepTimer(window=8), ts.StepTimer(window=8)
    rng = np.random.default_rng(0)
    for x in rng.exponential(1.0, 60):
        a.observe(float(x))
        b.observe(float(x))
        assert (b.median, b.mad) == (a.median, a.mad)
        for probe in (0.5, 2.0, 5.0, 20.0):
            assert b.is_straggling(probe) == a.is_straggling(probe)


def test_bounded_skip_equals_the_reference():
    rng = np.random.default_rng(42)
    for max_c in (0, 1, 3):
        a, b = js.BoundedSkip(max_consecutive=max_c), \
            ts.BoundedSkip(max_consecutive=max_c)
        for stall in rng.random(300) < 0.7:
            assert b.decide(bool(stall)) == a.decide(bool(stall))
            assert b.skipped == a.skipped


def test_adaptive_schedule_equals_the_reference():
    kw = dict(C=0.5, delta=1 / 300, t_total=1.0, K=3, h_max=10**6,
              hysteresis=1.3)
    a, b = js.AdaptiveSchedule(**kw), ts.AdaptiveSchedule(**kw)
    for t_delay in (4e-3, 4.4e-3, 4e-1, 3e-1, 1e-4, 2e-2):
        assert b.replan(t_lp=4e-5, t_delay=t_delay, t_cp=3e-5) == \
            a.replan(t_lp=4e-5, t_delay=t_delay, t_cp=3e-5)
        assert b.current_h == a.current_h


@pytest.mark.parametrize("adaptive", [False, True])
def test_straggler_policy_steps_equal_the_reference_over_20_chunks(adaptive):
    jm, tm = models()
    ad_kw = dict(C=0.5, delta=1 / 64, t_total=1.0, K=4)
    a = js.StragglerPolicy(model=jm, max_consecutive=2, seed=3,
                           adaptive=js.AdaptiveSchedule(**ad_kw)
                           if adaptive else None)
    b = ts.StragglerPolicy(model=tm, max_consecutive=2, seed=3,
                           adaptive=ts.AdaptiveSchedule(**ad_kw)
                           if adaptive else None)
    base = [0.01, 0.012, 0.02, 0.011, 0.015]
    for run in range(2):          # a re-bind advances the delay stream
        a.bind(base, t_compute=1e-3, t_lp=1e-5)
        b.bind(base, t_compute=1e-3, t_lp=1e-5)
        for chunk in range(20):
            if chunk == 10:
                a.retime(2e-3)
                b.retime(2e-3)
            final = chunk == 19
            sa, sb = a.step(final=final), b.step(final=final)
            np.testing.assert_array_equal(sb.mask, sa.mask)
            assert sb.mask.dtype == sa.mask.dtype
            np.testing.assert_array_equal(sb.delays, sa.delays)
            assert (sb.dt_async, sb.dt_sync, sb.h_suggest) == \
                (sa.dt_async, sa.dt_sync, sa.h_suggest)
        assert sb.mask.all()                     # the final barrier
        assert b.last_h_suggest == a.last_h_suggest


# ---------------------------------------------------------------------------
# the straggler-aware planner, exactly
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_consecutive", [0, 1, 2, 3])
def test_simulate_bounded_skip_equals_the_reference(max_consecutive):
    jm, tm = models()
    base = [0.01, 0.02, 0.01, 0.03]
    kw = dict(max_consecutive=max_consecutive, n_rounds=200, seed=5)
    assert td.simulate_bounded_skip(base, tm, **kw) == \
        jd.simulate_bounded_skip(base, jm, **kw)


@pytest.mark.parametrize("calm", [False, True])
def test_optimal_h_bounded_skip_equals_the_reference(calm):
    kw = dict(slow_prob=0.0, slow_factor=1.0, jitter=0.0) if calm else \
        dict(slow_prob=0.2, slow_factor=50.0, jitter=0.02)
    args = dict(C=0.5, K=4, delta=1 / 64, t_total=1.0, t_lp=1e-5, t_cp=0.0,
                base_delays=[0.01] * 4, skip_max=3, h_max=10**5)
    want = jd.optimal_h_bounded_skip(model=jd.StragglerModel(**kw), **args)
    got = td.optimal_h_bounded_skip(model=td.StragglerModel(**kw), **args)
    assert got == want
    assert (got["skip"] == 0) == calm


@pytest.mark.parametrize("case", ["star", "two_level"])
def test_schedule_auto_with_a_straggler_model_resolves_the_same(case):
    topo = TOPOLOGIES[case]()
    jm, tm = models()
    want = JSchedule.auto(t_total=1.0, straggler=jm, skip_max=3,
                          h_max=10**4).resolve(topo)
    got = Schedule.auto(t_total=1.0, straggler=tm, skip_max=3,
                        h_max=10**4).resolve(port(topo))
    assert got.skip == want.skip and got.skip is not None
    assert got.straggler_model == tm
    assert got.level_plan == want.level_plan
    assert got.rounds == want.rounds
    assert got.per_round_time == want.per_round_time
    assert port(JTopology.from_tree(want.chunk_tree)).to_dict() == \
        Topology.from_tree(got.chunk_tree).to_dict()


# ---------------------------------------------------------------------------
# straggler sessions against the reference
# ---------------------------------------------------------------------------
def assert_straggler_runs_close(res, ref):
    np.testing.assert_allclose(res.alpha.numpy(), np.asarray(ref.alpha),
                               **TOL)
    np.testing.assert_allclose(res.w.numpy(), np.asarray(ref.w), **TOL)
    np.testing.assert_allclose(res.gaps, ref.gaps, **TOL)
    for key in ("round", "time", "time_sync", "participants", "h"):
        assert [h.get(key) for h in res.history] == \
            [h.get(key) for h in ref.history], key
    np.testing.assert_array_equal(
        res.next_key.numpy(), np.asarray(ref.next_key).astype(np.int64))


@pytest.mark.parametrize("case", sorted(TOPOLOGIES))
def test_straggler_run_matches_the_reference(case):
    topo = TOPOLOGIES[case]()
    X, y = data(topo.m_total)
    jm, tm = models()
    rounds = topo.tree.rounds
    ref = JSession.compile(JProblem(X, y, lam=LAM), topo).run(
        rounds=rounds, key=jax.random.PRNGKey(0),
        straggler=js.StragglerPolicy(model=jm, max_consecutive=2, seed=1))
    sess = Session.compile(Problem(X, y, lam=LAM), port(topo),
                           backend="torch", device="cpu")
    res = sess.run(rounds=rounds, key=prng.PRNGKey(0),
                   straggler=ts.StragglerPolicy(model=tm, max_consecutive=2,
                                                seed=1))
    assert_straggler_runs_close(res, ref)
    parts = [h["participants"] for h in res.history[1:]]
    assert min(parts) < topo.n_leaves and parts[-1] == topo.n_leaves
    # the final barrier restores w = A alpha; async time beats sync time
    np.testing.assert_allclose(
        res.w.numpy(),
        TD.w_of_alpha(res.alpha, torch.from_numpy(X), LAM).numpy(), **TOL)
    assert res.history[-1]["time"] <= res.history[-1]["time_sync"]


class _FixedH:
    """An AdaptiveSchedule that always suggests ``target`` (the reference
    test's double), built for either package."""

    @staticmethod
    def build(base, target, **kw):
        class Fixed(base):
            def replan(self, t_lp, t_delay, t_cp=0.0):
                self.current_h = target
                return target
        return Fixed(**kw)


@pytest.mark.parametrize("local_h,target", [(None, 3), ([4, 8, 12, 6], 12)])
def test_adaptive_straggler_run_matches_the_reference(local_h, target):
    topo = JTopology.star(4, 16, rounds=4, local_steps=12, t_lp=1e-4,
                          t_delay=1e-3)
    X, y = data(topo.m_total, d=6)
    kw = dict(C=0.5, delta=1 / 16, t_total=1.0, K=4)
    ref = JSession.compile(JProblem(X, y, lam=LAM), topo).run(
        rounds=4, key=jax.random.PRNGKey(1), local_h=local_h,
        straggler=js.StragglerPolicy(
            max_consecutive=0, seed=0,
            adaptive=_FixedH.build(js.AdaptiveSchedule, target, **kw)))
    sess = Session.compile(Problem(X, y, lam=LAM), port(topo),
                           backend="torch", device="cpu")
    res = sess.run(rounds=4, key=prng.PRNGKey(1), local_h=local_h,
                   straggler=ts.StragglerPolicy(
                       max_consecutive=0, seed=0,
                       adaptive=_FixedH.build(ts.AdaptiveSchedule, target,
                                              **kw)))
    assert_straggler_runs_close(res, ref)
    assert [h["h"] for h in res.history[1:]] == \
        [12, target, target, target]
    # the suggestion drives the next chunks' step mask: a manual replay
    first = sess.run(rounds=1, key=prng.PRNGKey(1), local_h=local_h,
                     record_history=False)
    manual = sess.run(rounds=3, warm_start=first, local_h=target,
                      record_history=False)
    assert torch.equal(res.alpha, manual.alpha)
    assert torch.equal(res.w, manual.w)


@pytest.mark.parametrize("case", ["star", "two_level"])
def test_always_participate_policy_is_the_synchronous_run(case):
    topo = port(TOPOLOGIES[case]())
    X, y = data(topo.m_total, d=8)
    sess = Session.compile(Problem(X, y, lam=LAM), topo, backend="torch",
                           device="cpu")
    plain = sess.run(rounds=5, key=prng.PRNGKey(3))
    pol = ts.StragglerPolicy(
        model=td.StragglerModel(slow_prob=0.9, slow_factor=50.0),
        max_consecutive=0, seed=0)
    async_ = sess.run(rounds=5, key=prng.PRNGKey(3), straggler=pol)
    assert torch.equal(plain.alpha, async_.alpha)
    assert torch.equal(plain.w, async_.w)
    assert plain.gaps.tolist() == async_.gaps.tolist()


@pytest.mark.parametrize("case", sorted(TOPOLOGIES))
def test_chunk_masks_preserve_the_w_invariant(case):
    """Whole-chunk skips through the port's executor keep w = A alpha
    (tests/test_straggler.py::test_chunk_masks_preserve_w_invariant), and
    equal the reference executor under the same masks."""
    topo = TOPOLOGIES[case]()
    tree = topo.tree
    X, y = data(topo.m_total)
    jp, tp = jplan.compile_tree(tree), tplan.compile_tree(port(topo).tree)
    keys = jplan.key_plan(tree, jp, jax.random.PRNGKey(1))
    per = tp.n_ticks // tree.rounds
    part = np.ones((tp.n_ticks, tp.n_leaves), np.float32)
    rng = np.random.default_rng(0)
    for r in range(1, tree.rounds - 1):
        part[r * per:(r + 1) * per, rng.random(tp.n_leaves) < 0.3] = 0.0
    part[per:2 * per, :] = 0.0       # a chunk nobody attends: a no-op
    a, w = thost.execute_plan(tp, torch.from_numpy(X), torch.from_numpy(y),
                              keys, loss=TD.squared, lam=LAM,
                              backend="torch", participation=part)
    np.testing.assert_allclose(
        w.numpy(), TD.w_of_alpha(a, torch.from_numpy(X), LAM).numpy(), **TOL)
    ja, jw = jhost.execute_plan(jp, X, y, keys, loss=JD.squared, lam=LAM,
                                record_history=False, participation=part)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)


def test_one_masked_step_from_the_same_mid_run_state_matches_jax():
    """A reference straggler chunk's carry handed to the port
    (exec_state_from_reference), then one more masked chunk in both."""
    topo = TOPOLOGIES["two_level"]()
    tree = dataclasses.replace(topo.tree, rounds=1)
    jp = jplan.compile_tree(tree)
    tp = tplan.compile_tree(dataclasses.replace(port(topo).tree, rounds=1))
    X, y = data(tree.total_data(), d=12)
    loss = JProblem(X, y).loss
    jex = jhost.get_host_executor(jp, loss=loss, record_history=False,
                                  carry_state=True)
    lm = jhost.regularizer_scale(LAM, len(X), X.dtype)
    keys = jplan.chunked_key_plan(tree, jp, jax.random.PRNGKey(4), 3)
    steps = jplan.full_steps(jp)
    masks = [jplan.chunk_participation(jp, m)
             for m in ([1, 0, 1, 1], [0, 1, 1, 0], [1, 1, 0, 1])]
    st = jex.init(X, np.zeros(len(X), np.float32),
                  np.zeros(X.shape[1], np.float32))
    for r in range(2):
        st = jex.step(X, y, keys[r], st, masks[r], steps, lm)
    mid = jax.tree.map(np.asarray, st)
    want = jax.tree.map(np.asarray, jex.step(X, y, keys[2], st, masks[2],
                                             steps, lm))
    tex = thost.get_host_executor(tp, loss=Problem(X, y).loss,
                                  backend="torch", device="cpu")
    got = tex.step(tex.prepare(torch.from_numpy(X), torch.from_numpy(y)),
                   prng.as_key(keys[2]),
                   convert.exec_state_from_reference(mid, device="cpu"),
                   torch.from_numpy(masks[2]), torch.from_numpy(steps),
                   thost.regularizer_scale(LAM, len(X)))
    np.testing.assert_allclose(got.a.numpy(), want[0], **TOL)
    np.testing.assert_allclose(got.w.numpy(), want[1], **TOL)
    for field, i in (("snapA", 2), ("snapW", 3), ("srvW", 4)):
        for dd, v in enumerate(getattr(got, field)):
            np.testing.assert_allclose(v.numpy(), want[i][dd], **TOL,
                                       err_msg=field)


def test_warm_restart_continues_the_straggler_clock():
    topo = TOPOLOGIES["star"]()
    X, y = data(topo.m_total, d=8)
    ref_sess = JSession.compile(JProblem(X, y, lam=LAM), topo)
    r1 = ref_sess.run(rounds=3, key=jax.random.PRNGKey(5),
                      straggler=js.StragglerPolicy(seed=2))
    r2 = ref_sess.run(rounds=3, warm_start=r1,
                      straggler=js.StragglerPolicy(seed=9))
    sess = Session.compile(Problem(X, y, lam=LAM), port(topo),
                           backend="torch", device="cpu")
    p1 = sess.run(rounds=3, key=prng.PRNGKey(5),
                  straggler=ts.StragglerPolicy(seed=2))
    p2 = sess.run(rounds=3, warm_start=p1,
                  straggler=ts.StragglerPolicy(seed=9))
    hist = p1.history + p2.history
    assert [h["round"] for h in hist] == list(range(7))
    assert [h["time"] for h in hist] == \
        [h["time"] for h in r1.history + r2.history]
    assert_straggler_runs_close(p2, r2)


def test_straggler_policy_of_an_auto_schedule():
    topo = JTopology.star(4, 64, rounds=8, local_steps=32, t_lp=1e-5,
                          t_delay=0.01)
    X, y = data(topo.m_total, d=8)
    jm = jd.StragglerModel(slow_prob=0.2, slow_factor=50.0, jitter=0.02)
    tm = td.StragglerModel(slow_prob=0.2, slow_factor=50.0, jitter=0.02)
    jsess = JSession.compile(JProblem(X, y, lam=LAM), topo, JSchedule.auto(
        t_total=1.0, straggler=jm, skip_max=3, h_max=10**4))
    sess = Session.compile(Problem(X, y, lam=LAM), port(topo),
                           Schedule.auto(t_total=1.0, straggler=tm,
                                         skip_max=3, h_max=10**4),
                           backend="torch", device="cpu")
    assert sess.resolved.skip == jsess.resolved.skip > 0
    assert {"skip", "participation"} <= set(sess.level_plan[0])
    pol, jpol = sess.straggler_policy(seed=0), jsess.straggler_policy(seed=0)
    assert pol.max_consecutive == jpol.max_consecutive
    assert pol.model is tm
    assert_straggler_runs_close(sess.run(rounds=6, straggler=pol),
                                jsess.run(rounds=6, straggler=jpol))
    with pytest.raises(ValueError, match="straggler"):
        Session.compile(Problem(X, y, lam=LAM), port(topo), backend="torch",
                        device="cpu").straggler_policy()


def test_straggler_refusals_and_solve_forwarding():
    topo = port(TOPOLOGIES["star"]())
    X, y = data(topo.m_total, d=8)
    sess = Session.compile(Problem(X, y, lam=LAM), topo, backend="torch",
                           device="cpu")
    with pytest.raises(ValueError,
                       match="checkpoint= does not compose with straggler="):
        sess.run(rounds=2, straggler=ts.StragglerPolicy(), checkpoint="d")
    res = solve(Problem(X, y, lam=LAM), topo, backend="torch", device="cpu",
                rounds=3, key=prng.PRNGKey(0),
                straggler=ts.StragglerPolicy(seed=4))
    want = sess.run(rounds=3, key=prng.PRNGKey(0),
                    straggler=ts.StragglerPolicy(seed=4))
    assert torch.equal(res.alpha, want.alpha)
    assert [h["participants"] for h in res.history[1:]] == \
        [h["participants"] for h in want.history[1:]]


def test_rejoin_in_a_one_group_round_chunk_keeps_the_w_invariant():
    """A fault of the reference the port does not share (ROADMAP queue C):
    with one group round per root round, a leaf's group sync and root sync
    fall on the same tick, and a leaf re-joining after an absence takes
    its stale root snapshot as the baseline of its root delta, so the
    server re-delivers the progress it missed and the final barrier no
    longer gives w = A alpha.  The port fast-forwards that baseline to
    the root server within the tick, as the reference does between ticks;
    the reference's own run of the same policy is off by over 1%."""
    topo = JTopology.two_level(4, 4, 16, root_rounds=6, group_rounds=1,
                               local_steps=16, t_lp=1e-6, root_delay=5e-2,
                               group_delay=1e-4)
    X, y = data(topo.m_total, d=12)
    jm, tm = models()
    ref = JSession.compile(JProblem(X, y, lam=LAM), topo).run(
        key=jax.random.PRNGKey(0),
        straggler=js.StragglerPolicy(model=jm, max_consecutive=2, seed=1))
    res = Session.compile(Problem(X, y, lam=LAM), port(topo),
                          backend="torch", device="cpu").run(
        key=prng.PRNGKey(0),
        straggler=ts.StragglerPolicy(model=tm, max_consecutive=2, seed=1))
    parts = [h["participants"] for h in res.history[1:]]
    assert parts == [h["participants"] for h in ref.history[1:]]
    assert min(parts) < 16 and parts[-1] == 16
    w_ref = np.asarray(JD.w_of_alpha(ref.alpha, X, LAM))
    ref_err = np.abs(np.asarray(ref.w) - w_ref).max() / np.abs(w_ref).max()
    assert ref_err > 1e-2
    np.testing.assert_allclose(
        res.w.numpy(),
        TD.w_of_alpha(res.alpha, torch.from_numpy(X), LAM).numpy(), **TOL)
