"""The port's main path -- Problem + Topology + Schedule -> Session.run --
against the JAX package's Session on tests/test_api.py's scenarios, plus
the port's own contracts (exact warm restarts, all-ones masks, the
convert round trip).  The CUDA backend on the card is tested in
tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.api import Problem as JProblem  # noqa: E402
from repro.api import Schedule as JSchedule  # noqa: E402
from repro.api import Session as JSession  # noqa: E402
from repro.api import Topology as JTopology  # noqa: E402
from repro.core import dual as jdual  # noqa: E402
from repro.core.engine import host as jhost  # noqa: E402
from repro.core.engine import plan as jplan  # noqa: E402
from repro_torch.api import Problem, Schedule, Session, Topology  # noqa: E402
from repro_torch.api import convert  # noqa: E402
from repro_torch.core import dual as tdual  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.engine import host as thost  # noqa: E402
from repro_torch.core.engine import plan as tplan  # noqa: E402
from repro_torch.kernels.sdca import kernel as t_kernel  # noqa: E402
from test_api import TOPOLOGIES  # noqa: E402
from test_torch_dual import jloss  # noqa: E402

torch.set_num_threads(1)

LAM = 0.1
# the engine oracle's float32 tolerance (verify skill): the same
# arithmetic in two libraries, summed in different orders
TOL = dict(rtol=1e-4, atol=1e-5)


def port_topology(case) -> Topology:
    return Topology.from_json(TOPOLOGIES[case]().to_json())


def data(m, d=12, seed=0, labels=False):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((m, d)).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    if labels:
        y = np.where(y >= 0, 1.0, -1.0).astype(np.float32)
    return X, y


def assert_close_runs(res, ref):
    np.testing.assert_allclose(res.alpha.numpy(), np.asarray(ref.alpha),
                               **TOL)
    np.testing.assert_allclose(res.w.numpy(), np.asarray(ref.w), **TOL)
    assert [h["round"] for h in res.history] == \
        [h["round"] for h in ref.history]
    np.testing.assert_allclose(res.times, ref.times, rtol=1e-12)
    for field in ("duals", "primals", "gaps"):
        np.testing.assert_allclose(getattr(res, field), getattr(ref, field),
                                   **TOL, err_msg=field)
    np.testing.assert_array_equal(
        res.next_key.numpy(), np.asarray(ref.next_key).astype(np.int64))


@pytest.mark.parametrize("jax_backend", ["vmap", "pallas"])
@pytest.mark.parametrize("case", sorted(TOPOLOGIES))
def test_session_run_matches_jax(case, jax_backend):
    topo = TOPOLOGIES[case]()
    X, y = data(topo.m_total)
    ref = JSession.compile(JProblem(X, y, lam=LAM), topo,
                           backend=jax_backend).run(
        key=jax.random.PRNGKey(3))
    res = Session.compile(Problem(X, y, lam=LAM), port_topology(case),
                          backend="torch", device="cpu").run(
        key=prng.PRNGKey(3))
    assert_close_runs(res, ref)


@pytest.mark.parametrize("loss", ["hinge", "smooth_hinge_1", "logistic"])
def test_session_run_matches_jax_classification_losses(loss):
    topo = TOPOLOGIES["two_level"]()
    X, y = data(topo.m_total, seed=1, labels=True)
    ref = JSession.compile(JProblem(X, y, loss=jloss(loss), lam=LAM),
                           topo).run(rounds=3, key=jax.random.PRNGKey(1))
    res = Session.compile(Problem(X, y, loss=loss, lam=LAM),
                          port_topology("two_level"), backend="torch",
                          device="cpu").run(rounds=3, key=prng.PRNGKey(1))
    assert_close_runs(res, ref)


def test_heterogeneous_runtime_h_and_size_weighting_match_jax():
    """h_cap capacity + a per-leaf runtime H (step masks), size-weighted
    aggregation, history decimation and a lambda override."""
    topo = TOPOLOGIES["imbalanced"]()
    X, y = data(topo.m_total, seed=2)
    sj = JSchedule(rounds=4, h_cap=40, weighting="size")
    st = Schedule(rounds=4, h_cap=40, weighting="size")
    h = [10, 40, 25, 5, 30, 15]
    kw = dict(local_h=h, lam=0.05, history_every=3)
    ref = JSession.compile(JProblem(X, y, lam=LAM), topo, sj).run(
        key=jax.random.PRNGKey(8), **kw)
    res = Session.compile(Problem(X, y, lam=LAM), port_topology(
        "imbalanced"), st, backend="torch", device="cpu").run(
        key=prng.PRNGKey(8), **kw)
    assert_close_runs(res, ref)
    assert [e["round"] for e in res.history] == [0, 3, 4]


def test_execute_plan_with_participation_mask_matches_jax():
    """A leaf absent for a whole chunk: renormalized weights, the
    per-depth server carry and the stale-snapshot fast-forward."""
    tree = TOPOLOGIES["imbalanced"]().tree
    ptree = port_topology("imbalanced").tree
    a, b = jplan.compile_tree(tree), tplan.compile_tree(ptree)
    X, y = data(tree.total_data(), seed=3)
    keys = jplan.key_plan(tree, a, jax.random.PRNGKey(2))
    part = jplan.chunk_participation(a, [1, 0, 1, 1, 0, 1])
    steps = jplan.steps_for_h(a, 20)
    ja, jw = jhost.execute_plan(a, X, y, keys, loss=JProblem(X, y).loss,
                                lam=LAM, record_history=False,
                                participation=part, steps=steps)
    ta, tw = thost.execute_plan(b, torch.from_numpy(X), torch.from_numpy(y),
                                keys, loss=Problem(X, y).loss, lam=LAM,
                                backend="torch", participation=part,
                                steps=steps)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)


def test_split_run_with_warm_start_equals_one_long_run_bitwise():
    topo = port_topology("two_level")
    X, y = data(topo.m_total, seed=4)
    sess = Session.compile(Problem(X, y, lam=LAM), topo, backend="torch",
                           device="cpu")
    once = sess.run(rounds=5, key=prng.PRNGKey(7))
    first = sess.run(rounds=2, key=prng.PRNGKey(7))
    rest = sess.run(rounds=3, warm_start=first)
    assert torch.equal(rest.alpha, once.alpha)
    assert torch.equal(rest.w, once.w)
    assert torch.equal(rest.next_key, once.next_key)
    assert first.history + rest.history == once.history


def test_all_ones_step_mask_gives_the_static_h_result_bitwise():
    topo = port_topology("star")
    X, y = data(topo.m_total, seed=5)
    sess = Session.compile(Problem(X, y, lam=LAM), topo, backend="torch",
                           device="cpu")
    static = sess.run(rounds=3, key=prng.PRNGKey(1), record_history=False)
    ones = sess.run(rounds=3, key=prng.PRNGKey(1), record_history=False,
                    local_h=80)                  # == the compiled H
    assert torch.equal(static.alpha, ones.alpha)
    assert torch.equal(static.w, ones.w)


def test_cuda_backend_on_cpu_tensors_is_the_plain_path_bitwise():
    topo = port_topology("imbalanced")
    X, y = data(topo.m_total, seed=6)
    prob = Problem(X, y, lam=LAM)
    before = t_kernel.LAUNCHES
    a = Session.compile(prob, topo, backend="cuda", device="cpu").run(
        rounds=2, key=prng.PRNGKey(2))
    b = Session.compile(prob, topo, backend="torch", device="cpu").run(
        rounds=2, key=prng.PRNGKey(2))
    assert t_kernel.LAUNCHES == before
    assert torch.equal(a.alpha, b.alpha) and torch.equal(a.w, b.w)


def test_custom_loss_session_matches_the_references_registered_loss():
    """A registered loss the kernel has no closed form for (the squared
    loss's formulas under a new name, ``kind`` "", with its step in CUDA
    C++ for the card) against the reference's ``register_loss`` of the
    same formulas, which its kernels trace.  On CPU tensors
    ``backend="cuda"`` runs the plain version, the loss's ``coord_delta``,
    so it equals ``backend="torch"`` bit for bit."""
    name = "squared_by_formula"
    jdual.register_loss(jdual.Loss(name, jdual.squared.value,
                                   jdual.squared.conj_neg,
                                   jdual.squared.coord_delta, gamma=1.0))
    custom = tdual.register_loss(tdual.Loss(
        name, tdual.squared.value, tdual.squared.conj_neg,
        tdual.squared.coord_delta, gamma=1.0,
        cuda="return (y - wx - a) / (1.0f + xsq);"))
    assert t_kernel.loss_id(custom) == t_kernel.CUSTOM_ID
    topo = TOPOLOGIES["two_level"]()
    X, y = data(topo.m_total, seed=2)
    ref = JSession.compile(JProblem(X, y, loss=name, lam=LAM), topo,
                           backend="pallas").run(
        rounds=3, key=jax.random.PRNGKey(1))
    before = t_kernel.LAUNCHES
    runs = [Session.compile(Problem(X, y, loss=name, lam=LAM),
                            port_topology("two_level"), backend=backend,
                            device="cpu").run(rounds=3, key=prng.PRNGKey(1))
            for backend in ("cuda", "torch")]
    assert t_kernel.LAUNCHES == before          # no kernel ran
    assert_close_runs(runs[0], ref)
    assert torch.equal(runs[0].alpha, runs[1].alpha)
    assert torch.equal(runs[0].w, runs[1].w)


def test_convert_carries_a_reference_run_into_the_port():
    """JAX runs 2 rounds, the port continues 3 from its converted result:
    the same iterates as JAX running 5 (state and RNG chain carried)."""
    topo = TOPOLOGIES["star"]()
    X, y = data(topo.m_total, seed=7)
    jsess = JSession.compile(JProblem(X, y, lam=LAM), topo)
    long = jsess.run(rounds=5, key=jax.random.PRNGKey(4))
    head = jsess.run(rounds=2, key=jax.random.PRNGKey(4))
    start = convert.from_reference(
        np.asarray(head.alpha), np.asarray(head.w), head.history,
        np.asarray(head.next_key), lam=head.lam, device="cpu")
    prob = convert.problem_from_numpy(X, y, "squared", LAM, device="cpu")
    tail = Session.compile(prob, port_topology("star"), backend="torch",
                           device="cpu").run(rounds=3, warm_start=start)
    np.testing.assert_allclose(tail.alpha.numpy(), np.asarray(long.alpha),
                               **TOL)
    np.testing.assert_allclose(tail.w.numpy(), np.asarray(long.w), **TOL)
    np.testing.assert_array_equal(
        tail.next_key.numpy(), np.asarray(long.next_key).astype(np.int64))
    assert [e["round"] for e in tail.history] == [3, 4, 5]
    back = convert.to_reference(tail)
    again = convert.from_reference(**back, device="cpu")
    assert torch.equal(again.alpha, tail.alpha)
    assert torch.equal(again.next_key, tail.next_key)
    assert again.history == tail.history and again.lam == tail.lam


def test_cross_lambda_warm_start_rebuilds_w():
    topo = port_topology("star")
    X, y = data(topo.m_total, seed=8)
    sess = Session.compile(Problem(X, y, lam=LAM), topo, backend="torch",
                           device="cpu")
    res = sess.run(rounds=2, key=prng.PRNGKey(0))
    more = sess.run(rounds=0, warm_start=res, lam=0.5)
    Xt = torch.from_numpy(X)
    np.testing.assert_allclose(
        more.w.numpy(), (Xt.T @ res.alpha / (0.5 * len(X))).numpy(), **TOL)


def test_topology_json_round_trips_with_the_reference():
    for case in sorted(TOPOLOGIES):
        jt = TOPOLOGIES[case]()
        pt = port_topology(case)
        assert pt.to_dict() == jt.to_dict()
        assert Topology.from_json(pt.to_json()) == pt
        assert pt.n_leaves == jt.n_leaves and pt.m_total == jt.m_total
    bal = Topology.balanced([2, 3], m_leaf=16, local_steps=32,
                            level_rounds=[4, 2], level_delays=[0.5, 1e-3])
    assert bal.to_dict() == JTopology.balanced(
        [2, 3], m_leaf=16, local_steps=32, level_rounds=[4, 2],
        level_delays=[0.5, 1e-3]).to_dict()


def test_unported_options_raise():
    """What the port refuses: a mesh executor asked for without a mesh; an
    unknown method (the LM method is registered since the LM workload was
    ported); and what it refuses as the reference does."""
    from repro_torch.core.engine.method import get_method
    topo = port_topology("star")
    X, y = data(topo.m_total)
    Session.compile(Problem(X, y), topo, backend="torch", device="cpu")
    plan = tplan.compile_tree(topo.tree)
    with pytest.raises(ValueError, match="DeviceMesh"):
        get_method("sdca").executor(plan=plan, backend="mesh",
                                    loss=Problem(X, y).loss)
    assert get_method("lm_treesync").name == "lm_treesync"
    with pytest.raises(ValueError, match="unknown method 'lm_sweep'"):
        get_method("lm_sweep")
    with pytest.raises(ValueError):
        Session.compile(Problem(X[:-1], y[:-1]), topo, device="cpu")
    with pytest.raises(ValueError):
        Session.compile(Problem(X, y), topo, backend="vmap", device="cpu")


# ---------------------------------------------------------------------------
# the host executor cache (tests/test_api.py:146-172, tests/test_analysis.py)
# ---------------------------------------------------------------------------
def _star_session(strict=False, lam=0.07, accel=None):
    topo = Topology.star(3, 30, rounds=4, local_steps=50)
    X, y = data(90, d=6)
    return Session.compile(Problem(X, y, lam=lam), topo,
                           Schedule(acceleration=accel), backend="torch",
                           device="cpu", strict=strict)


def test_executor_cache_hits_on_repeated_solves():
    """Repeated Session.compile on the same tree reuses ONE executor (a
    hit, no rebuild), and the legacy engine.solve rides the same cache."""
    from repro_torch.core import engine
    s1 = _star_session()
    before = Session.cache_stats()
    s2 = _star_session()
    res1 = s1.run(record_history=False)
    res2 = s2.run(record_history=False)
    after = Session.cache_stats()
    assert after["misses"] == before["misses"], "executor was rebuilt"
    assert after["hits"] >= before["hits"] + 1
    assert s1.executor is s2.executor
    assert torch.equal(res1.alpha, res2.alpha)

    before = Session.cache_stats()
    res = engine.solve(s1.topology.tree, s1.problem.X, s1.problem.y,
                       loss=s1.problem.loss, lam=0.07, record_history=False,
                       backend="torch")
    after = Session.cache_stats()
    assert after["misses"] == before["misses"]
    assert torch.equal(res.alpha, res1.alpha)


def test_engine_solve_is_the_references_shim():
    """engine.solve: the reference's signature (the card backend by
    default) and its result on the same tree."""
    import inspect

    from repro.core import engine as jengine
    from repro_torch.core import engine
    sig = inspect.signature(engine.solve)
    jsig = inspect.signature(jengine.solve)
    assert list(jsig.parameters) == list(sig.parameters)[:len(jsig.parameters)]
    assert sig.parameters["backend"].default == "cuda"
    jtopo = JTopology.star(3, 30, rounds=4, local_steps=50)
    X, y = data(90, d=6)
    want = jengine.solve(jtopo.tree, X, y,
                         loss=JProblem(X, y, lam=0.07).loss, lam=0.07,
                         key=jax.random.PRNGKey(3))
    got = engine.solve(port_topology_of(jtopo).tree, torch.from_numpy(X),
                       torch.from_numpy(y),
                       loss=Problem(X, y, lam=0.07).loss, lam=0.07,
                       key=prng.PRNGKey(3), backend="torch")
    assert_close_runs(got, want)


def port_topology_of(jtopo) -> Topology:
    return Topology.from_json(jtopo.to_json())


def test_cache_stats_has_a_column_per_backend():
    stats = Session.cache_stats()
    assert set(stats) == {"hits", "misses", "size", "by_backend"}
    assert set(stats["by_backend"]) == {"cuda", "torch", "mesh", "lm"}
    b = stats["by_backend"]
    assert stats["hits"] == sum(v["hits"] for v in b.values())
    assert stats["misses"] == sum(v["misses"] for v in b.values())
    s = _star_session()
    assert s._fetch_executor() is s.executor
    assert Session.cache_stats()["by_backend"]["torch"]["hits"] >= \
        b["torch"]["hits"] + 1
    from repro_torch.core.engine.method import get_method
    assert get_method("sdca").cache_stats() == Session.cache_stats()
    keys = thost.executor_cache_keys()
    assert keys and set(keys[0]) == set(thost.EXEC_KEY_FIELDS)


def test_no_rebuild_across_lambda_local_h_and_acceleration():
    s1 = _star_session(lam=0.05)
    s2 = _star_session(lam=0.8)
    assert s1.executor is s2.executor, "lambda leaked into the cache key"
    before = Session.cache_stats()
    s1.run(key=prng.PRNGKey(0), record_history=False, local_h=10)
    s1.run(key=prng.PRNGKey(0), record_history=False, local_h=[5, 20, 50])
    s1.run(key=prng.PRNGKey(0), record_history=False, lam=0.3)
    assert Session.cache_stats()["misses"] == before["misses"]
    a1 = _star_session(accel=0.5)
    before = Session.cache_stats()
    a2 = _star_session(accel=0.2, lam=0.3)
    a1.run(record_history=False, acceleration=0.0)
    a1.run(record_history=False, acceleration=0.9)
    a2.run(record_history=False)
    assert a1.executor is a2.executor
    assert Session.cache_stats()["misses"] == before["misses"]
    assert a1.executor is not s1.executor


def test_strict_catches_a_forced_host_rebuild():
    """Evicting the session's executor forces a rebuild on the next run:
    strict mode raises UnexpectedRetraceError naming the host backend (and
    the session runs again after), a non-strict session rebuilds
    silently; strict and plain runs are bit-equal."""
    from repro_torch.analysis import UnexpectedRetraceError
    sess = _star_session(strict=True)
    first = sess.run(key=prng.PRNGKey(0))
    plain = _star_session().run(key=prng.PRNGKey(0))
    assert torch.equal(first.alpha, plain.alpha)
    thost.clear_executor_cache()
    with pytest.raises(UnexpectedRetraceError, match="cache miss") as e:
        sess.run(key=prng.PRNGKey(0))
    assert e.value.misses[0]["backend"] == "torch"
    assert "plan_fingerprint" in e.value.misses[0]["key"]
    again = sess.run(key=prng.PRNGKey(0))      # the rebuilt entry hits
    assert torch.equal(again.alpha, first.alpha)
    loose = _star_session()
    thost.clear_executor_cache()
    loose.run(key=prng.PRNGKey(0))            # no raise


def test_no_retrace_reports_the_host_keys_diff():
    from repro_torch.analysis import UnexpectedRetraceError, no_retrace
    s = _star_session()
    thost.get_host_executor(s.plan, loss=s.problem.loss, backend="torch",
                            device="cpu")
    with no_retrace():
        thost.get_host_executor(s.plan, loss=s.problem.loss,
                                backend="torch", device="cpu")
    with pytest.raises(UnexpectedRetraceError) as e:
        with no_retrace():
            thost.get_host_executor(s.plan, loss=s.problem.loss,
                                    backend="torch", device="cpu",
                                    batched=True)
    assert e.value.misses[-1]["diff"] == {"batched": (True, False)}
    assert thost.executor_miss_log()[-1]["key"]["batched"] is True
