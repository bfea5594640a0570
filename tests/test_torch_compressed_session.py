"""Compressed and delay-planned sessions of the port against the JAX
package's: error-feedback runs (level specs, per-depth lists, per-edge
overrides, Topology.with_compression), one state-executor step from the
same mid-run state, the eq.-(12) auto schedules (explicit and fitted C,
compression="auto"), and the bit-identity contracts of the port's own
executors.  Small sizes throughout: the reference's small_problem (star
4 x 32, d = 24) and two-level trees of 4 leaves."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.api import DelayModel as JDelayModel  # noqa: E402
from repro.api import Problem as JProblem  # noqa: E402
from repro.api import Schedule as JSchedule  # noqa: E402
from repro.api import Session as JSession  # noqa: E402
from repro.api import Topology as JTopology  # noqa: E402
from repro.core.engine import host as jhost  # noqa: E402
from repro.core.engine import plan as jplan  # noqa: E402
from repro_torch.api import (DelayModel, Problem, Schedule, Session,  # noqa: E402
                             Topology, convert, solve)
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.engine import host as thost  # noqa: E402
from repro_torch.core.engine import plan as tplan  # noqa: E402

torch.set_num_threads(1)

LAM = 0.1
# the session parity tolerance of tests/test_torch_session.py: the same
# float32 arithmetic in two libraries, summed in other orders
TOL = dict(rtol=1e-4, atol=1e-5)
# DelayModel(C="auto"): the fitted C is (1 - median gap ratio) K / (1 -
# (1 - delta)^H) over the pilot's gaps, which agree to TOL; the ratio's
# relative error is amplified by up to 1 / (1 - g) ~ 10 at the pilot's
# contraction, so C is held to 1e-3 relative
C_RTOL = 1e-3


def port(topo: JTopology) -> Topology:
    return Topology.from_json(topo.to_json())


def data(m, d=24, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)).astype(np.float32),
            rng.standard_normal(m).astype(np.float32))


def small_star():
    """The reference's small_problem topology
    (tests/test_compression.py)."""
    return JTopology.star(4, 32, rounds=30, local_steps=32, t_lp=1e-6,
                          t_delay=1e-3)


def small_two_level():
    return JTopology.two_level(2, 2, 32, root_rounds=4, group_rounds=3,
                               local_steps=16, t_lp=1e-6, root_delay=5e-2,
                               group_delay=1e-4)


def with_edge_override(topo: JTopology) -> JTopology:
    """The first root child's up-link overridden to top-k."""
    tree = topo.tree
    first = dataclasses.replace(tree.children[0], up_compress="topk_0.2")
    return JTopology.from_tree(dataclasses.replace(
        tree, children=(first,) + tree.children[1:]))


CASES = {
    "star-int8": (small_star, "int8"),
    "star-topk": (small_star, "topk_0.25"),
    "two_level-int8": (small_two_level, "int8"),
    "two_level-per_depth": (small_two_level, ["topk_0.5", "int8"]),
    "two_level-root_only": (small_two_level, ["int8", None]),
    "two_level-edge_override": (
        lambda: with_edge_override(small_two_level()), "int8"),
    "star-edge_override_only": (lambda: with_edge_override(small_star()),
                                None),
    "two_level-with_compression": (
        lambda: small_two_level().with_compression("int8",
                                                   min_up_delay=1e-2),
        None),
}


def assert_runs_close(res, ref):
    np.testing.assert_allclose(res.alpha.numpy(), np.asarray(ref.alpha),
                               **TOL)
    np.testing.assert_allclose(res.w.numpy(), np.asarray(ref.w), **TOL)
    np.testing.assert_allclose(res.gaps, ref.gaps, **TOL)
    np.testing.assert_allclose(res.times, ref.times, rtol=1e-12)
    np.testing.assert_array_equal(
        res.next_key.numpy(), np.asarray(ref.next_key).astype(np.int64))


@pytest.mark.parametrize("case", sorted(CASES))
def test_compressed_run_matches_jax(case):
    build, spec = CASES[case]
    topo = build()
    X, y = data(topo.m_total)
    jsess = JSession.compile(JProblem(X, y, lam=LAM), topo,
                             JSchedule(rounds=5, compression=spec))
    sess = Session.compile(Problem(X, y, lam=LAM), port(topo),
                           Schedule(rounds=5, compression=spec),
                           backend="torch", device="cpu")
    assert sess.plan.has_compression
    assert sess.plan.fingerprint == jsess.plan.fingerprint
    assert sess.resolved.compression == jsess.resolved.compression
    assert sess.bytes_per_round == jsess.bytes_per_round
    assert sess.resolved.per_round_time == jsess.resolved.per_round_time
    assert_runs_close(sess.run(key=prng.PRNGKey(3), history_every=2),
                      jsess.run(key=jax.random.PRNGKey(3), history_every=2))


def one_quantum(target: np.ndarray) -> np.ndarray:
    """Per element, one int8 quantum of its 32-element block along the
    last axis: what one flipped code moves a dequantized value by."""
    n, d = target.shape
    pad = (-d) % tcomp.BLOCK
    blocks = np.pad(np.abs(target), ((0, 0), (0, pad))).reshape(
        n, -1, tcomp.BLOCK)
    q = blocks.max(-1, keepdims=True) / 127.0
    return np.broadcast_to(q, blocks.shape).reshape(n, -1)[:, :d]


@pytest.mark.parametrize("spec", ["int8", ["topk_0.25", "int8"],
                                  ["int8", None]])
def test_one_step_from_the_same_mid_run_state_matches_jax(spec):
    """Two root rounds in the reference's state executor, its carry handed
    to the port (exec_state_from_reference), one more step in both.  The
    blocked state agrees to TOL; each residual to TOL plus, on int8 edges,
    one quantum of its block (a last-ulp difference in the message can
    flip one code)."""
    topo = small_two_level()
    tree = dataclasses.replace(topo.tree, rounds=1)
    a = jplan.compile_tree(tree, compression=spec)
    b = tplan.compile_tree(dataclasses.replace(port(topo).tree, rounds=1),
                           compression=spec)
    assert b.fingerprint == a.fingerprint
    X, y = data(tree.total_data(), d=40, seed=1)
    loss = JProblem(X, y).loss
    jex = jhost.get_host_executor(a, loss=loss, record_history=False,
                                  carry_state=True)
    lm = jhost.regularizer_scale(LAM, len(X), X.dtype)
    keys = jplan.chunked_key_plan(tree, a, jax.random.PRNGKey(1), 3)
    part, steps = jplan.full_participation(a), jplan.full_steps(a)
    st = jex.init(X, np.zeros(len(X), np.float32),
                  np.zeros(X.shape[1], np.float32))
    for r in range(2):
        st = jex.step(X, y, keys[r], st, part, steps, lm)
    mid = jax.tree.map(np.asarray, st)
    want = jax.tree.map(np.asarray, jex.step(X, y, keys[2], st, part,
                                             steps, lm))
    tex = thost.get_host_executor(b, loss=Problem(X, y).loss,
                                  backend="torch", device="cpu",
                                  carry_state=True)
    start = convert.exec_state_from_reference(mid, device="cpu")
    got = tex.step(tex.prepare(torch.from_numpy(X), torch.from_numpy(y)),
                   prng.as_key(keys[2]), start, torch.from_numpy(part),
                   torch.from_numpy(steps), thost.regularizer_scale(LAM,
                                                                    len(X)))
    np.testing.assert_allclose(got.a.numpy(), want[0], **TOL)
    np.testing.assert_allclose(got.w.numpy(), want[1], **TOL)
    for field, i in (("snapA", 2), ("snapW", 3), ("srvW", 4)):
        for dd, v in enumerate(getattr(got, field)):
            np.testing.assert_allclose(v.numpy(), want[i][dd], **TOL,
                                       err_msg=field)
    comp_depths = [dd for dd in range(a.depth)
                   if a.compress_kind[dd].any()]
    assert len(got.res) == len(want[5]) == len(comp_depths)
    for r_got, r_want, dd in zip(got.res, want[5], comp_depths, strict=True):
        assert r_want.any()
        err = np.abs(r_got.numpy() - r_want)
        allow = TOL["atol"] + TOL["rtol"] * np.abs(r_want)
        int8_rows = a.compress_kind[dd] == tcomp.KIND_INT8
        allow[int8_rows] += one_quantum(
            (want[1] - want[3][dd]).astype(np.float32) + r_want)[int8_rows]
        assert (err <= allow).all(), (dd, err.max())


# ---------------------------------------------------------------------------
# the eq.-(12) planner: resolved auto schedules equal the reference's
# ---------------------------------------------------------------------------
def with_tlp(topo: JTopology, t_lp: float) -> JTopology:
    def visit(node):
        kids = tuple(visit(c) for c in node.children)
        return dataclasses.replace(node, children=kids,
                                   t_lp=t_lp if node.is_leaf else 0.0)
    return JTopology.from_tree(visit(topo.tree))


AUTO_CASES = {
    # reference tests/test_api.py::test_auto_rounds_reproduces_plan_...
    "two_level": (lambda: JTopology.two_level(
        2, 2, 32, root_delay=0.05, group_delay=1e-4, t_lp=1e-5),
        dict(t_total=2.0, C=0.5, t_cp=2e-5, h_max=10**4)),
    # ...::test_auto_rounds_inherits_topology_t_cp (both t_cp views)
    "star_t_cp": (lambda: JTopology.star(3, 100, t_lp=4e-5, t_cp=3e-3,
                                         t_delay=0.1),
                  dict(t_total=1.0, h_max=10**5)),
    "star_t_cp0": (lambda: JTopology.star(3, 100, t_lp=4e-5, t_cp=3e-3,
                                          t_delay=0.1),
                   dict(t_total=1.0, t_cp=0.0, h_max=10**5)),
    # ...::test_auto_rounds_beats_fixed_default_time_to_gap
    "slow_root": (lambda: JTopology.two_level(
        2, 2, 32, root_rounds=10, group_rounds=2, local_steps=16,
        t_lp=1e-5, root_delay=1.0, group_delay=1e-4),
        dict(t_total=8.0, t_cp=0.0, h_max=2**12)),
    # reference tests/test_compression.py::test_schedule_auto_compression_
    # end_to_end
    "compress_auto": (lambda: with_tlp(JTopology.two_level(
        2, 2, 16, root_delay=5e-2, group_delay=1e-5, local_steps=8), 1e-6),
        dict(t_total=1.0, C=0.5, compression="auto")),
    "compress_auto_h_cap": (lambda: with_tlp(JTopology.two_level(
        2, 2, 16, root_delay=5e-2, group_delay=1e-5, local_steps=8), 1e-6),
        dict(t_total=1.0, C=0.5, compression="auto", h_cap=64)),
    "compress_list": (small_two_level,
                      dict(t_total=0.5, C=0.3, compression=["int8", None])),
    "star_compress_auto": (small_star,
                           dict(t_total=0.05, C=0.5, h_max=256,
                                compression="auto")),
}


def assert_resolved_equal(got, want):
    assert Topology.from_tree(got.chunk_tree).to_dict() == \
        JTopology.from_tree(want.chunk_tree).to_dict()
    assert got.rounds == want.rounds
    assert got.level_plan == want.level_plan
    assert got.compression == want.compression
    assert got.per_round_time == want.per_round_time
    assert got.runtime_h == want.runtime_h
    assert got.ckpt_every == want.ckpt_every
    assert got.skip is want.skip is None


@pytest.mark.parametrize("case", sorted(AUTO_CASES))
def test_auto_schedule_resolves_like_jax(case):
    build, kw = AUTO_CASES[case]
    topo = build()
    assert_resolved_equal(Schedule.auto(**kw).resolve(port(topo)),
                          JSchedule.auto(**kw).resolve(topo))


def test_delay_model_schedule_and_checkpoint_period_resolve_like_jax():
    topo = AUTO_CASES["two_level"][0]()
    for dm in (dict(t_total=2.0, C=0.5, t_cp=2e-5, h_max=10**4),
               dict(t_total=2.0, C=0.5, h_max=10**4, ckpt_write=0.05,
                    mtbf=30.0),
               dict(t_total=3.0, C=1.0, delta=0.01, h_max=500)):
        for comp in (None, "int8", "auto"):
            got = Schedule(rounds="auto", delay=DelayModel(**dm),
                           compression=comp).resolve(port(topo))
            want = JSchedule(rounds="auto", delay=JDelayModel(**dm),
                             compression=comp).resolve(topo)
            assert_resolved_equal(got, want)
    # explicit schedules carry the checkpoint period too
    got = Schedule(rounds=7, compression="int8", delay=DelayModel(
        t_total=1.0, ckpt_write=0.01, mtbf=5.0)).resolve(port(topo))
    want = JSchedule(rounds=7, compression="int8", delay=JDelayModel(
        t_total=1.0, ckpt_write=0.01, mtbf=5.0)).resolve(topo)
    assert_resolved_equal(got, want)


def test_auto_schedule_validation_matches_jax():
    topo = Topology.two_level(2, 2, 8)                  # t_lp = 0
    with pytest.raises(ValueError, match="DelayModel"):
        Schedule(rounds="auto").resolve(topo)
    with pytest.raises(ValueError, match="t_lp"):
        Schedule.auto(t_total=1.0).resolve(topo)
    with pytest.raises(ValueError, match="rounds='auto'"):
        Schedule(compression="auto").resolve(Topology.star(4, 8))
    with pytest.raises(ValueError, match="all 1 internal depths"):
        Schedule(compression=["int8", "int8"]).resolve(Topology.star(4, 8))
    with pytest.raises(ValueError, match="Session.compile"):
        Schedule.auto(t_total=1.0, C="auto").resolve(port(small_star()))
    with pytest.raises(ValueError):
        DelayModel(t_total=1.0, C="fast")
    with pytest.raises(ValueError):
        DelayModel(t_total=1.0, C="auto", pilot_rounds=1)


@pytest.mark.parametrize("case", ["two_level", "compress_auto"])
def test_fitted_C_and_auto_run_match_jax(case):
    """DelayModel(C="auto"): the pilot on the port's own backend fits C
    within C_RTOL of the reference's; the session plans with it and its
    run matches the reference's."""
    build, kw = AUTO_CASES[case]
    topo = build()
    kw = dict(kw, C="auto", pilot_rounds=4)
    X, y = data(topo.m_total, d=8, seed=2)
    jsess = JSession.compile(JProblem(X, y, lam=LAM), topo,
                             JSchedule.auto(**kw))
    sess = Session.compile(Problem(X, y, lam=LAM), port(topo),
                           Schedule.auto(**kw), backend="torch", device="cpu")
    assert sess.fitted_C == pytest.approx(jsess.fitted_C, rel=C_RTOL)
    assert sess.level_plan is sess.resolved.level_plan
    assert [r["H"] for r in sess.level_plan] == \
        [r["H"] for r in jsess.level_plan]
    assert sess.resolved.compression == jsess.resolved.compression
    assert sess.resolved.rounds == jsess.resolved.rounds
    assert sess.bytes_per_round == jsess.bytes_per_round
    assert_runs_close(sess.run(rounds=3, key=prng.PRNGKey(0)),
                      jsess.run(rounds=3, key=jax.random.PRNGKey(0)))


# ---------------------------------------------------------------------------
# the port's own bit-identity contracts
# ---------------------------------------------------------------------------
def test_compression_none_is_bit_identical_to_no_compression():
    topo = port(JTopology.star(4, 32, rounds=10, local_steps=32))
    X, y = data(topo.m_total)
    prob = Problem.ridge(X, y, lam=LAM)
    r0 = solve(prob, topo, Schedule(), backend="torch", device="cpu",
               key=prng.PRNGKey(3))
    r1 = solve(prob, topo, Schedule(compression="none"), backend="torch",
               device="cpu", key=prng.PRNGKey(3))
    assert torch.equal(r0.alpha, r1.alpha) and torch.equal(r0.w, r1.w)
    assert r0.history == r1.history


@pytest.mark.parametrize("case", ["star", "two_level"])
def test_state_steps_are_bit_identical_to_the_flat_executor(case):
    """Uncompressed, all-ones masks: init -> step^T -> finalize equals T
    root rounds of the flat executor, bit for bit."""
    topo = port(small_star() if case == "star" else small_two_level())
    X, y = data(topo.m_total, seed=3)
    sess = Session.compile(Problem(X, y, lam=LAM), topo,
                           Schedule(rounds=4), backend="torch", device="cpu")
    flat = sess.run(key=prng.PRNGKey(2), record_history=False)
    ex, plan = sess.executor, sess.plan
    keys = prng.as_key(tplan.chunked_key_plan(
        sess.resolved.chunk_tree, plan, prng.PRNGKey(2), 4))
    part = torch.from_numpy(tplan.full_participation(plan))
    steps = torch.from_numpy(tplan.full_steps(plan))
    lm = thost.regularizer_scale(LAM, len(X))
    state = ex.init(sess.problem.X, torch.zeros(len(X)),
                    torch.zeros(X.shape[1]))
    assert state.res == ()
    for t in range(4):
        state = ex.step(sess.data, keys[t], state, part, steps, lm)
    alpha, w = ex.finalize(state)
    assert torch.equal(alpha, flat.alpha) and torch.equal(w, flat.w)


def test_identical_compressed_runs_are_bit_identical():
    topo = port(small_two_level())
    X, y = data(topo.m_total, seed=4)
    sess = Session.compile(Problem(X, y, lam=LAM), topo,
                           Schedule(rounds=4, compression=["topk_0.3",
                                                           "int8"]),
                           backend="torch", device="cpu")
    r1 = sess.run(key=prng.PRNGKey(5))
    r2 = sess.run(key=prng.PRNGKey(5))
    assert torch.equal(r1.alpha, r2.alpha) and torch.equal(r1.w, r2.w)
    assert r1.history == r2.history
    # the cuda backend on CPU tensors is the plain path, bit for bit
    r3 = Session.compile(Problem(X, y, lam=LAM), topo,
                         Schedule(rounds=4, compression=["topk_0.3",
                                                         "int8"]),
                         backend="cuda", device="cpu").run(
        key=prng.PRNGKey(5))
    assert torch.equal(r1.alpha, r3.alpha) and torch.equal(r1.w, r3.w)
