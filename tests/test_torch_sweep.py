"""Sweeps in the port (``api/sweep.py``: Sweep / RunSet / Session.sweep /
sweep) against the JAX package, and the batched executor they run on.

* ``Sweep.expand`` gives the reference's point list, exactly;
* every RunSet member is ``torch.equal`` to the port's standalone
  ``Session.run`` of that config (histories and RNG chain included), and
  within ``TOL`` of the reference's ``Session.sweep`` member;
* covered: lambda x seed grids, ``continuation=True``, a ``local_hs`` axis
  under ``h_cap``, a ``schedules`` axis, a compressed group and an
  accelerated group -- the non-mesh, non-checkpoint cases of
  ``tests/test_sweep.py``;
* one batched executor step from the reference's batched carry agrees
  with the reference's step.
Small stars (d <= 8) throughout."""
import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.api import Problem as JProblem  # noqa: E402
from repro.api import Schedule as JSchedule  # noqa: E402
from repro.api import Session as JSession  # noqa: E402
from repro.api import Sweep as JSweep  # noqa: E402
from repro.api import Topology as JTopology  # noqa: E402
from repro.core.engine import host as jhost  # noqa: E402
from repro.core.engine import plan as jplan  # noqa: E402
from repro.data.synthetic import gaussian_regression  # noqa: E402
from repro_torch.api import (Problem, Schedule, Session, Sweep,  # noqa: E402
                             Topology, convert, sweep)
from repro_torch.core import dual as TD  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.engine import host as thost  # noqa: E402
from repro_torch.core.engine import plan as tplan  # noqa: E402

torch.set_num_threads(1)
# the module (repro_torch.api.sweep is also the name of the one-shot
# function the package exports)
sweep_mod = importlib.import_module("repro_torch.api.sweep")

LAM = 0.1
# members against the reference's: the same float32 arithmetic in two
# libraries, summed in other orders, over a few rounds of iterates of
# order 1; against the port's own standalone runs the members are
# bit-equal
TOL = dict(rtol=1e-5, atol=1e-5)


def star():
    return JTopology.star(4, 40, rounds=5, local_steps=40)


def small_star():
    return JTopology.star(3, 16, rounds=3, local_steps=12)


def port(topo: JTopology) -> Topology:
    return Topology.from_json(topo.to_json())


def data(m, d=8):
    X, y = gaussian_regression(m=m, d=d)
    return np.array(X), np.array(y)


def sessions(topo, sched=None, jsched=None, d=8):
    """The port's session (torch backend, CPU) and the reference's."""
    X, y = data(topo.m_total, d)
    sess = Session.compile(Problem(X, y, lam=LAM), port(topo), sched,
                           backend="torch", device="cpu")
    jsess = JSession.compile(JProblem(X, y, lam=LAM), topo, jsched)
    return sess, jsess


def assert_members(rs, jrs, standalone):
    """Each member: equal to its standalone port run, close to the
    reference's member."""
    assert len(rs) == len(jrs)
    for pt in rs.points:
        mem, want = rs[pt.index], jrs[pt.index]
        single = standalone(pt)
        assert torch.equal(mem.alpha, single.alpha), pt
        assert torch.equal(mem.w, single.w), pt
        assert mem.history == single.history, pt
        assert torch.equal(mem.next_key, single.next_key)
        np.testing.assert_allclose(mem.alpha.numpy(), np.asarray(want.alpha),
                                   **TOL)
        np.testing.assert_allclose(mem.w.numpy(), np.asarray(want.w), **TOL)
        np.testing.assert_allclose(mem.gaps, want.gaps, **TOL)
        np.testing.assert_allclose(mem.times, want.times, rtol=1e-12)
        np.testing.assert_array_equal(
            mem.next_key.numpy(), np.asarray(want.next_key).astype(np.int64))


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(lams=[0.1, 0.2, 0.3], seeds=[0, 1]),
    dict(lams=[0.1, 0.2], local_hs=[2, [4, 8, 12]], seeds=[5]),
    dict(schedules=["s0", "s1"], lams=[0.5]),
    dict(lams=[0.1, 0.2, 0.3], seeds=[5, 6, 7], mode="zip"),
    dict(seeds=[0, 1, 2], local_hs=[3, 4, 5], mode="zip"),
    dict(lams=[1.0, 0.1], seeds=[0, 7], continuation=True),
])
def test_sweep_expand_equals_the_reference(kw):
    want = JSweep(**kw)
    got = Sweep(**kw)
    assert got.shape == want.shape
    assert [p.to_dict() for p in got.expand(0.25)] == \
        [p.to_dict() for p in want.expand(0.25)]
    assert [p.index for p in got.expand(0.25)] == \
        [p.index for p in want.expand(0.25)]


def test_sweep_validation_matches_the_reference():
    with pytest.raises(ValueError, match="at least one axis"):
        Sweep()
    for kw in (dict(lams=[]), dict(lams=[0.1], mode="diagonal"),
               dict(lams=[0.1, 0.2], seeds=[0, 1, 2], mode="zip"),
               dict(seeds=[0, 1], continuation=True),
               dict(lams=[1.0, 0.1], mode="zip", continuation=True,
                    seeds=[0, 1])):
        with pytest.raises(ValueError) as port_err:
            Sweep(**kw)
        with pytest.raises(ValueError) as ref_err:
            JSweep(**kw)
        assert str(port_err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# members: bit-equal to standalone runs, close to the reference
# ---------------------------------------------------------------------------
def test_lambda_seed_sweep_members():
    topo = star()
    sess, jsess = sessions(topo)
    rs = sess.sweep(lams=[0.03, 0.1, 0.5], seeds=[0, 7])
    jrs = jsess.sweep(lams=[0.03, 0.1, 0.5], seeds=[0, 7])
    assert len(rs) == 6 and rs.shape == (3, 2) == jrs.shape
    assert_members(rs, jrs, lambda pt: sess.run(
        key=prng.PRNGKey(pt.seed), lam=pt.lam))
    # a standalone session compiled at the member's lambda is the same run
    pt = rs.points[3]
    other = Session.compile(Problem(sess.problem.X, sess.problem.y,
                                    lam=pt.lam), port(topo),
                            backend="torch", device="cpu").run(
        key=prng.PRNGKey(pt.seed))
    assert torch.equal(rs[pt.index].alpha, other.alpha)


def test_continuation_sweep_members():
    topo = star()
    sess, jsess = sessions(topo)
    lams, seeds = [1.0, 0.1, 0.03], [0, 7]
    rs = sess.sweep(lams=lams, seeds=seeds, continuation=True)
    jrs = jsess.sweep(lams=lams, seeds=seeds, continuation=True)
    X = sess.problem.X
    chains = {}

    def standalone(pt):
        prev = chains.get((pt.seed, pt.lam))
        if prev is not None:
            return prev
        i = lams.index(pt.lam)
        warm = None
        if i > 0:
            up = standalone(next(p for p in rs.points
                                 if p.seed == pt.seed
                                 and p.lam == lams[i - 1]))
            warm = (up.alpha, TD.w_of_alpha(up.alpha.clone(), X, pt.lam))
        chains[(pt.seed, pt.lam)] = res = sess.run(
            key=prng.PRNGKey(pt.seed), lam=pt.lam, warm_start=warm)
        return res
    assert_members(rs, jrs, standalone)
    # ||w|| grows as lambda shrinks along each chain
    for seed in seeds:
        norms = [float(torch.linalg.norm(rs[p.index].w)) for p in rs.points
                 if p.seed == seed]
        assert norms == sorted(norms)
    # the fused stages equal the member-at-a-time runner
    seq = sweep_mod._run_group_sequential(sess, rs.points, None, True, 1,
                                          True)
    for pt, res in zip(rs.points, seq, strict=True):
        assert torch.equal(rs[pt.index].alpha, res.alpha)
        assert rs[pt.index].history == res.history
    # the requested (unsorted) order is kept
    rs2 = sess.sweep(lams=[0.1, 3.0, 0.3], continuation=True, rounds=2,
                     record_history=False)
    assert [pt.lam for pt in rs2.points] == [0.1, 3.0, 0.3]


def test_local_h_axis_under_h_cap():
    topo = JTopology.star(3, 16, rounds=4, local_steps=8)
    sess, jsess = sessions(topo, Schedule(h_cap=32), JSchedule(h_cap=32),
                           d=6)
    hs = [2, 8, 32, [4, 16, 32]]
    rs = sess.sweep(lams=[0.05, 0.5], local_hs=hs)
    jrs = jsess.sweep(lams=[0.05, 0.5], local_hs=hs)
    assert rs.shape == (2, 4)
    assert_members(rs, jrs, lambda pt: sess.run(
        key=prng.PRNGKey(0), lam=pt.lam, local_h=pt.local_h))
    assert not torch.equal(rs.alphas[0], rs.alphas[1])
    assert rs.to_dict()["configs"][3]["local_h"] == [4, 16, 32]
    rz = sess.sweep(lams=[0.1, 0.2], local_hs=[2, 8], mode="zip",
                    record_history=False)
    assert [(p.lam, p.local_h) for p in rz.points] == [(0.1, 2), (0.2, 8)]


def test_schedules_axis():
    topo = star()
    scheds = [(Schedule(rounds=3, local_steps=10),
               JSchedule(rounds=3, local_steps=10)),
              (Schedule(rounds=6, local_steps=20),
               JSchedule(rounds=6, local_steps=20))]
    sess, jsess = sessions(topo)
    rs = sess.sweep(schedules=[s for s, _ in scheds], lams=[0.05, 0.5])
    jrs = jsess.sweep(schedules=[s for _, s in scheds], lams=[0.05, 0.5])
    assert rs.shape == (2, 2) and rs.gaps.shape == (4, 7)
    assert np.isnan(rs.gaps[0, 4:]).all() and np.isfinite(rs.gaps[2]).all()
    np.testing.assert_array_equal(np.isnan(rs.gaps), np.isnan(jrs.gaps))

    def standalone(pt):
        return Session.compile(
            Problem(sess.problem.X, sess.problem.y, lam=pt.lam), port(topo),
            scheds[pt.schedule][0], backend="torch", device="cpu").run(
            key=prng.PRNGKey(0))
    assert_members(rs, jrs, standalone)


@pytest.mark.parametrize("kind", ["compressed", "accelerated"])
def test_stateful_group_members(kind):
    topo = small_star()
    kw = dict(compression="topk_0.25") if kind == "compressed" else \
        dict(acceleration=0.5)
    sess, jsess = sessions(topo, Schedule(**kw), JSchedule(**kw))
    rs = sess.sweep(lams=[0.05, 0.4], seeds=[0, 2])
    jrs = jsess.sweep(lams=[0.05, 0.4], seeds=[0, 2])
    assert_members(rs, jrs, lambda pt: sess.run(
        key=prng.PRNGKey(pt.seed), lam=pt.lam))


def test_sweep_with_an_int8_group_and_history_every():
    topo = JTopology.two_level(2, 2, 24, root_rounds=7, group_rounds=2,
                               local_steps=16)
    sess, jsess = sessions(topo, Schedule(compression="int8"),
                           JSchedule(compression="int8"))
    rs = sess.sweep(lams=[0.05, 0.5], history_every=3)
    jrs = jsess.sweep(lams=[0.05, 0.5], history_every=3)
    for i in range(len(rs)):
        assert [h["round"] for h in rs[i].history] == [0, 3, 6, 7]
    assert rs.gaps.shape == (2, 4)
    assert_members(rs, jrs, lambda pt: sess.run(
        key=prng.PRNGKey(0), lam=pt.lam, history_every=3))


# ---------------------------------------------------------------------------
# RunSet, one-shot sweep, refusals
# ---------------------------------------------------------------------------
def test_runset_best_final_and_to_dict():
    topo = star()
    sess, jsess = sessions(topo)
    rs = sess.sweep(lams=[0.02, 0.2, 2.0], seeds=[0, 1])
    jrs = jsess.sweep(lams=[0.02, 0.2, 2.0], seeds=[0, 1])
    np.testing.assert_allclose(rs.final("gap"), jrs.final("gap"), **TOL)
    assert rs.best_index("gap") == jrs.best_index("gap")
    assert rs.best_index("dual") == jrs.best_index("dual")
    assert rs.best("gap").gaps[-1] == rs.final("gap")[rs.best_index()]
    blob = json.loads(json.dumps(rs.to_dict()))
    jblob = json.loads(json.dumps(jrs.to_dict()))
    assert blob["shape"] == jblob["shape"] == [3, 2]
    assert blob["configs"] == jblob["configs"]
    assert np.asarray(blob["alphas"]).shape == (6, sess.problem.m)
    np.testing.assert_allclose(blob["final_gap"], jblob["final_gap"], **TOL)
    rs2 = sess.sweep(lams=[0.1], rounds=1, record_history=False)
    assert "history" not in rs2.to_dict()
    with pytest.raises(ValueError, match="record_history"):
        rs2.gaps
    keyed = sess.sweep(seeds=[prng.PRNGKey(4)], rounds=1)
    assert keyed.to_dict()["configs"][0]["seed"] == [0, 4]
    assert torch.equal(keyed[0].alpha, sess.run(rounds=1,
                                                key=prng.PRNGKey(4)).alpha)


def test_one_shot_sweep_and_refusals(tmp_path):
    topo = small_star()
    X, y = data(topo.m_total)
    prob = Problem(X, y, lam=LAM)
    rs = sweep(prob, port(topo), lams=[0.1, 0.3], backend="torch",
               device="cpu")
    sess = Session.compile(prob, port(topo), backend="torch", device="cpu")
    assert torch.equal(rs.alphas, sess.sweep(lams=[0.1, 0.3]).alphas)
    with pytest.raises(ValueError, match="not both"):
        sweep(prob, port(topo), Sweep(lams=[0.1, 0.2]), mode="zip",
              backend="torch", device="cpu")
    fleet = tmp_path / "fleet"
    with pytest.raises(ValueError, match="disagree"):
        sess.sweep(Sweep(lams=[0.1], resume=fleet), checkpoint=str(
            tmp_path / "elsewhere"))
    one_shot = sweep(prob, port(topo), lams=[0.1], checkpoint=str(fleet),
                     backend="torch", device="cpu")
    assert (fleet / "fleet.json").exists()
    assert torch.equal(one_shot.alphas, sess.sweep(lams=[0.1]).alphas)


# ---------------------------------------------------------------------------
# the batched executor against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("accelerated", [False, True])
def test_one_batched_step_from_the_reference_batched_carry(accelerated):
    """Two chunks in the reference's batched state executor (a lambda grid
    with per-config keys and H), its carry handed to the port's batched
    executor, one more step in both."""
    topo = JTopology.star(3, 16, rounds=1, local_steps=12)
    tree = topo.tree
    X, y = data(topo.m_total, d=6)
    jp, tp = jplan.compile_tree(tree), tplan.compile_tree(port(topo).tree)
    lams, hs = [0.05, 0.5], [12, 7]
    B = len(lams)
    jex = jhost.get_host_executor(jp, loss=JProblem(X, y).loss,
                                  record_history=False, carry_state=True,
                                  batched=True, accelerated=accelerated)
    keys = np.stack([jplan.chunked_key_plan(tree, jp, jax.random.PRNGKey(s),
                                            3) for s in range(B)])
    steps = np.stack([jplan.steps_for_h(jp, h) for h in hs])
    part = jplan.full_participation(jp)
    lms = np.stack([np.asarray(jhost.regularizer_scale(v, len(X), X.dtype))
                    for v in lams])
    acc = (np.float32(0.5),) if accelerated else ()
    st = jex.init(X, np.zeros((B, len(X)), np.float32),
                  np.zeros((B, X.shape[1]), np.float32))
    for r in range(2):
        st = jex.step(X, y, keys[:, r], st, part, steps, lms, *acc)
    mid = jax.tree.map(np.asarray, st)
    want = jax.tree.map(np.asarray, jex.step(X, y, keys[:, 2], st, part,
                                             steps, lms, *acc))
    tex = thost.get_host_executor(tp, loss=Problem(X, y).loss,
                                  backend="torch", device="cpu",
                                  batched=True, accelerated=accelerated)
    start = convert.exec_state_from_reference(mid, device="cpu")
    assert start.a.shape == (B, tp.n_leaves, tp.m_b)
    got = tex.step(tex.prepare(torch.from_numpy(X), torch.from_numpy(y)),
                   prng.as_key(keys[:, 2]), start, torch.from_numpy(part),
                   torch.from_numpy(steps),
                   [thost.regularizer_scale(v, len(X)) for v in lams],
                   *((0.5,) if accelerated else ()))
    np.testing.assert_allclose(got.a.numpy(), want[0], **TOL)
    np.testing.assert_allclose(got.w.numpy(), want[1], **TOL)
    a_flat, w_flat = tex.finalize(got)
    assert a_flat.shape == (B, len(X)) and w_flat.shape == (B, X.shape[1])
    # each config of the batched step equals a one-config step on its slice
    one = thost.get_host_executor(tp, loss=Problem(X, y).loss,
                                  backend="torch", device="cpu",
                                  accelerated=accelerated)
    for b in range(B):
        single = one.step(
            one.prepare(torch.from_numpy(X), torch.from_numpy(y)),
            prng.as_key(keys[b, 2]),
            convert.exec_state_from_reference(
                jax.tree.map(lambda t, b=b: t[b], mid), device="cpu"),
            torch.from_numpy(part), torch.from_numpy(steps[b]),
            thost.regularizer_scale(lams[b], len(X)),
            *((0.5,) if accelerated else ()))
        assert torch.equal(single.a, got.a[b])
        assert torch.equal(single.w, got.w[b])


def test_batched_cuda_backend_on_cpu_tensors_runs_the_plain_version():
    """backend="cuda" with CPU tensors: the wrapper takes the plain version
    (no launch counted) and the sweep equals the torch backend's."""
    from repro_torch.kernels.sdca import kernel
    topo = small_star()
    X, y = data(topo.m_total)
    n0 = kernel.LAUNCHES
    a = Session.compile(Problem(X, y, lam=LAM), port(topo), backend="cuda",
                        device="cpu").sweep(lams=[0.1, 0.2])
    b = Session.compile(Problem(X, y, lam=LAM), port(topo), backend="torch",
                        device="cpu").sweep(lams=[0.1, 0.2])
    assert kernel.LAUNCHES == n0
    assert torch.equal(a.alphas, b.alphas)


# ---------------------------------------------------------------------------
# the host executor cache under sweeps (tests/test_sweep.py:146-151,
# 234-238, 292-294)
# ---------------------------------------------------------------------------
def test_one_batched_build_per_sweep_grid():
    topo = JTopology.star(3, 30, rounds=4, local_steps=30)
    X, y = data(90, 6)
    s1 = Session.compile(Problem(X, y, lam=0.05), port(topo),
                         backend="torch", device="cpu")
    s2 = Session.compile(Problem(X, y, lam=0.8), port(topo),
                         backend="torch", device="cpu")
    assert s1.executor is s2.executor, \
        "lambda leaked into the executor cache key"
    thost.clear_executor_cache()
    before = Session.cache_stats()
    s1.sweep(lams=[0.01, 0.1, 1.0, 10.0], record_history=False)
    mid = Session.cache_stats()
    assert mid["misses"] == before["misses"] + 1   # the batched flavor
    s2.sweep(lams=[0.02, 0.2, 2.0], record_history=False)
    after = Session.cache_stats()
    assert after["misses"] == mid["misses"], \
        "a second lambda grid rebuilt the batched executor"


def test_runtime_h_changes_and_h_grids_build_nothing():
    topo = JTopology.star(3, 16, rounds=4, local_steps=8)
    sess, _ = sessions(topo, Schedule(h_cap=16), JSchedule(h_cap=16), d=6)
    key = prng.PRNGKey(0)
    sess.run(key=key, record_history=False)
    sess.sweep(lams=[0.1], local_hs=[2, 4], record_history=False)
    before = Session.cache_stats()
    sess.run(key=key, local_h=4, record_history=False)
    sess.run(key=key, local_h=16, record_history=False)
    sess.run(key=key, local_h=[1, 8, 16], record_history=False)
    assert Session.cache_stats()["misses"] == before["misses"], \
        "a runtime-H change rebuilt an executor"
    sess.sweep(lams=[0.1], local_hs=[3, 5, 7], record_history=False)
    assert Session.cache_stats()["misses"] == before["misses"]
