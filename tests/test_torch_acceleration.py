"""Accelerated server momentum in the port (``Schedule(acceleration=)``,
``get_method("sdca_acc")``) against the JAX package.

* ``acceleration=0`` is the plain run bit for bit (``torch.equal``), also
  compressed: the extrapolation is selected out of a ``torch.where``,
  not multiplied by zero;
* ``acceleration=0.5`` runs within ``TOL`` of the reference, also with
  int8 compression, and one accelerated step from the same mid-run state
  (momentum anchors included) agrees with the reference's step;
* ``run(acceleration=)`` overrides the coefficient and equals a session
  compiled at that value bit for bit;
* the refusals carry the reference's messages.
Small stars and two-level trees (d = 8)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.api import Problem as JProblem  # noqa: E402
from repro.api import Schedule as JSchedule  # noqa: E402
from repro.api import Session as JSession  # noqa: E402
from repro.api import Topology as JTopology  # noqa: E402
from repro.core.engine import host as jhost  # noqa: E402
from repro.core.engine import method as jmethod  # noqa: E402
from repro.core.engine import plan as jplan  # noqa: E402
from repro.data.synthetic import gaussian_regression  # noqa: E402
from repro_torch.api import (Problem, Schedule, Session, Topology,  # noqa: E402
                             convert)
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.engine import host as thost  # noqa: E402
from repro_torch.core.engine import method as tmethod  # noqa: E402
from repro_torch.core.engine import plan as tplan  # noqa: E402
from repro_torch.runtime.straggler import StragglerPolicy  # noqa: E402

torch.set_num_threads(1)

LAM = 0.1
# accelerated runs against the reference: the same float32 operations in
# two libraries; the reference compiles x + a * (x - p) as XLA fuses it
# (possibly one multiply-add), the port as two roundings, and the sums
# run in other orders.  Iterates of order 1 stay within 1e-5 over these
# few rounds
TOL = dict(rtol=1e-5, atol=1e-5)

TOPOLOGIES = {
    "star": lambda: JTopology.star(4, 24, rounds=5, local_steps=16),
    "two_level": lambda: JTopology.two_level(2, 2, 24, root_rounds=4,
                                             group_rounds=3,
                                             local_steps=16),
}


def port(topo: JTopology) -> Topology:
    return Topology.from_json(topo.to_json())


def data(m, d=8):
    X, y = gaussian_regression(m=m, d=d)
    return np.array(X), np.array(y)


def compile_port(X, y, topo, sched=None):
    return Session.compile(Problem(X, y, lam=LAM), port(topo), sched,
                           backend="torch", device="cpu")


def test_sdca_acc_is_a_registered_method():
    assert tmethod.get_method("sdca_acc").name == "sdca_acc"
    assert tmethod.get_method("sdca").name == "sdca"
    assert isinstance(tmethod.get_method("sdca_acc"), tmethod.SDCAMethod)
    # the LM method is registered as in the reference, so an unknown
    # method gives the reference's text, registry and all
    assert tmethod.get_method("lm_treesync").name == "lm_treesync"
    with pytest.raises(ValueError) as port_err:
        tmethod.get_method("no_such_method")
    with pytest.raises(ValueError) as ref_err:
        jmethod.get_method("no_such_method")
    assert str(port_err.value) == str(ref_err.value) == (
        "unknown method 'no_such_method'; registered: "
        "['lm_treesync', 'sdca', 'sdca_acc']")


@pytest.mark.parametrize("compression", [None, "int8"])
@pytest.mark.parametrize("case", sorted(TOPOLOGIES))
def test_acceleration_zero_is_the_plain_run(case, compression):
    topo = TOPOLOGIES[case]()
    X, y = data(topo.m_total)
    plain = compile_port(X, y, topo, Schedule(compression=compression)).run(
        key=prng.PRNGKey(0))
    acc0 = compile_port(X, y, topo, Schedule(acceleration=0.0,
                                             compression=compression)).run(
        key=prng.PRNGKey(0))
    assert torch.equal(acc0.alpha, plain.alpha)
    assert torch.equal(acc0.w, plain.w)
    assert acc0.gaps.tolist() == plain.gaps.tolist()
    assert torch.equal(acc0.next_key, plain.next_key)


@pytest.mark.parametrize("compression", [None, "int8"])
@pytest.mark.parametrize("case", sorted(TOPOLOGIES))
def test_acceleration_matches_the_reference(case, compression):
    topo = TOPOLOGIES[case]()
    X, y = data(topo.m_total)
    ref = JSession.compile(JProblem(X, y, lam=LAM), topo, JSchedule(
        acceleration=0.5, compression=compression)).run(
        key=jax.random.PRNGKey(3))
    res = compile_port(X, y, topo, Schedule(
        acceleration=0.5, compression=compression)).run(key=prng.PRNGKey(3))
    np.testing.assert_allclose(res.alpha.numpy(), np.asarray(ref.alpha),
                               **TOL)
    np.testing.assert_allclose(res.w.numpy(), np.asarray(ref.w), **TOL)
    np.testing.assert_allclose(res.gaps, ref.gaps, **TOL)
    np.testing.assert_allclose(res.times, ref.times, rtol=1e-12)


def test_acceleration_is_a_runtime_operand():
    topo = TOPOLOGIES["star"]()
    X, y = data(topo.m_total)
    sess = compile_port(X, y, topo, Schedule(acceleration=0.7))
    override = sess.run(key=prng.PRNGKey(3), acceleration=0.3)
    compiled = compile_port(X, y, topo, Schedule(acceleration=0.3)).run(
        key=prng.PRNGKey(3))
    assert torch.equal(override.alpha, compiled.alpha)
    assert torch.equal(override.w, compiled.w)
    ref = JSession.compile(JProblem(X, y, lam=LAM), topo, JSchedule(
        acceleration=0.7)).run(key=jax.random.PRNGKey(3), acceleration=0.3)
    np.testing.assert_allclose(override.alpha.numpy(), np.asarray(ref.alpha),
                               **TOL)
    with pytest.raises(ValueError, match="acceleration must be in"):
        sess.run(key=prng.PRNGKey(3), acceleration=2.0)


def test_acceleration_speeds_convergence():
    """tests/test_acceleration.py's claim in the port: at equal rounds the
    momentum run reaches a smaller duality gap on the paper's star."""
    topo = JTopology.star(8, 32, rounds=40, local_steps=8)
    X, y = data(256, d=24)
    plain = compile_port(X, y, topo).run(key=prng.PRNGKey(0))
    acc = compile_port(X, y, topo, Schedule(acceleration=0.6)).run(
        key=prng.PRNGKey(0))
    assert acc.gaps[-1] < 0.5 * plain.gaps[-1]


@pytest.mark.parametrize("compression", [None, "int8"])
def test_one_accelerated_step_from_the_same_mid_run_state(compression):
    """Two root rounds in the reference's accelerated state executor, its
    carry (momentum anchors included) handed to the port, one more step
    in both."""
    topo = TOPOLOGIES["two_level"]()
    tree = dataclasses.replace(topo.tree, rounds=1)
    jp = jplan.compile_tree(tree, compression=compression)
    tp = tplan.compile_tree(dataclasses.replace(port(topo).tree, rounds=1),
                            compression=compression)
    X, y = data(tree.total_data(), d=12)
    jex = jhost.get_host_executor(jp, loss=JProblem(X, y).loss,
                                  record_history=False, carry_state=True,
                                  accelerated=True)
    lm = jhost.regularizer_scale(LAM, len(X), X.dtype)
    acc = np.float32(0.5)
    keys = jplan.chunked_key_plan(tree, jp, jax.random.PRNGKey(2), 3)
    part, steps = jplan.full_participation(jp), jplan.full_steps(jp)
    st = jex.init(X, np.zeros(len(X), np.float32),
                  np.zeros(X.shape[1], np.float32))
    for r in range(2):
        st = jex.step(X, y, keys[r], st, part, steps, lm, acc)
    mid = jax.tree.map(np.asarray, st)
    want = jax.tree.map(np.asarray, jex.step(X, y, keys[2], st, part, steps,
                                             lm, acc))
    tex = tmethod.get_method("sdca_acc").executor(
        plan=tp, loss=Problem(X, y).loss, backend="torch", device="cpu")
    start = convert.exec_state_from_reference(mid, device="cpu")
    assert len(start.srvP) == len(start.srvA) == tp.depth
    got = tex.step(tex.prepare(torch.from_numpy(X), torch.from_numpy(y)),
                   prng.as_key(keys[2]), start, torch.from_numpy(part),
                   torch.from_numpy(steps),
                   thost.regularizer_scale(LAM, len(X)), 0.5)
    np.testing.assert_allclose(got.a.numpy(), want[0], **TOL)
    np.testing.assert_allclose(got.w.numpy(), want[1], **TOL)
    for field, i in (("snapA", 2), ("snapW", 3), ("srvW", 4), ("srvP", 5),
                     ("srvA", 6)):
        for dd, v in enumerate(getattr(got, field)):
            np.testing.assert_allclose(v.numpy(), want[i][dd], **TOL,
                                       err_msg=field)


def test_executor_acceleration_operand_checks():
    tree = port(TOPOLOGIES["star"]()).tree
    plan = tplan.compile_tree(tree)
    X, y = data(plan.m_total)
    loss = Problem(X, y).loss
    plain = thost.get_host_executor(plan, loss=loss, backend="torch",
                                    device="cpu")
    acc = thost.get_host_executor(plan, loss=loss, backend="torch",
                                  device="cpu", accelerated=True)
    data_b = plain.prepare(torch.from_numpy(X), torch.from_numpy(y))
    keys = prng.as_key(tplan.key_plan(tree, plan, prng.PRNGKey(0)))
    part = torch.from_numpy(tplan.full_participation(plan))
    steps = torch.from_numpy(tplan.full_steps(plan))
    z = torch.zeros(plan.m_total), torch.zeros(X.shape[1])
    with pytest.raises(ValueError, match="accelerated executor"):
        plain.step(data_b, keys, plain.init(data_b.Xb, *z), part, steps,
                   1.0, 0.5)
    with pytest.raises(ValueError, match="acceleration="):
        acc.step(data_b, keys, acc.init(data_b.Xb, *z), part, steps, 1.0)
    st = acc.init(data_b.Xb, *z)
    assert len(st.srvP) == len(st.srvA) == plan.depth


def test_acceleration_refusals_have_the_reference_messages():
    topo = TOPOLOGIES["star"]()
    X, y = data(topo.m_total)
    for bad in (1.5, -0.2):
        with pytest.raises(ValueError) as port_err:
            Schedule(acceleration=bad)
        with pytest.raises(ValueError) as ref_err:
            JSchedule(acceleration=bad)
        assert str(port_err.value) == str(ref_err.value)
    assert Schedule(acceleration=0.0).acceleration == 0.0
    plain = compile_port(X, y, topo)
    jplain = JSession.compile(JProblem(X, y, lam=LAM), topo)
    sess = compile_port(X, y, topo, Schedule(acceleration=0.5))
    jsess = JSession.compile(JProblem(X, y, lam=LAM), topo,
                             JSchedule(acceleration=0.5))
    from repro.runtime.straggler import StragglerPolicy as JPolicy
    pairs = [
        (lambda: plain.run(acceleration=0.5),
         lambda: jplain.run(acceleration=0.5)),
        (lambda: sess.run(straggler=StragglerPolicy(max_consecutive=1)),
         lambda: jsess.run(straggler=JPolicy(max_consecutive=1))),
        (lambda: sess.run(checkpoint="ckpt"),
         lambda: jsess.run(checkpoint="ckpt")),
    ]
    for port_call, ref_call in pairs:
        with pytest.raises(ValueError) as port_err:
            port_call()
        with pytest.raises(ValueError) as ref_err:
            ref_call()
        assert str(port_err.value) == str(ref_err.value)


def test_auto_schedule_plans_acceleration_as_the_reference():
    topo = JTopology.two_level(2, 2, 24, t_lp=1e-6, root_delay=5e-2,
                               group_delay=1e-4)
    want = JSchedule.auto(t_total=1.0, acceleration=0.5).resolve(topo)
    got = Schedule.auto(t_total=1.0, acceleration=0.5).resolve(port(topo))
    assert got.level_plan == want.level_plan
    assert got.rounds == want.rounds
