"""The port's elastic runtime (``repro_torch/runtime/fault.py``,
``Session.run(checkpoint=)`` / ``Session.resume``, ``Topology.with_leaf``
/ ``without_leaf``, fleet checkpoints) against its own uninterrupted runs
and against the JAX package.

Tolerances: a resumed or killed-and-resumed run of the port equals the
uninterrupted run bit for bit (``torch.equal`` on alpha, w and next_key,
``==`` on the history).  Across the packages, iterates agree within 1e-5
(float32, sums in other orders), keys, plans, fault draws and history
round / time axes exactly.  The reference's mesh cases
(``test_resume_bit_identity_mesh``, the mesh case of
``test_resume_compressed_plan_carries_residuals``, the subprocess
remesh) need the mesh backend and are not ported."""
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.api as J
import repro_torch.api as T
from repro.core.engine import plan as jplan
from repro.data.synthetic import gaussian_regression
from repro.runtime import fault as jfault
from repro_torch.api import (CheckpointPolicy, DelayModel, ElasticSession,
                             FaultModel, MembershipLog, Problem, Schedule,
                             Session, Sweep, Topology, run_with_faults)
from repro_torch.core import dual as dual_mod
from repro_torch.core import prng
from repro_torch.core.engine import plan as tplan
from repro_torch.core.instrument import SolveResult
from repro_torch.runtime import fault

LAM = 0.1
TOL = 1e-5


@pytest.fixture(scope="module")
def data():
    X, y = gaussian_regression(m=64, d=8)
    return np.array(X), np.array(y)


def _problem(data, lam=LAM):
    X, y = data
    return Problem(torch.from_numpy(X), torch.from_numpy(y), lam=lam)


def _star(rounds=6):
    return Topology.star(4, 16, rounds=rounds, local_steps=8)


def _session(data, schedule=None, backend="torch", topo=None):
    return Session.compile(_problem(data), topo or _star(), schedule,
                           backend=backend, device="cpu")


def _assert_same(res, ref):
    assert torch.equal(res.alpha, ref.alpha)
    assert torch.equal(res.w, ref.w)
    assert torch.equal(res.next_key, ref.next_key)
    assert res.history == ref.history


def _crash_after(root, round_):
    for f in Path(root).rglob("step_*.*"):
        if int(f.name.split(".")[0].split("_")[1]) > round_:
            f.unlink()


# ---------------------------------------------------------------------------
# crash mid-solve: bit identity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("every", [1, 2])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_resume_bit_identity(data, backend, every, tmp_path):
    """Kill after round 3 of 6 (every=2: the newest snapshot is round 3's
    forced final one, and round 2's was written a period late); the
    resumed run's iterates, RNG chain and history equal the uninterrupted
    solve's.  ``backend="cuda"`` on CPU tensors runs the kernel wrapper's
    plain version."""
    sess = _session(data, backend=backend)
    key = prng.PRNGKey(7)
    ref = sess.run(6, key=key)
    part = sess.run(3, key=key, checkpoint=CheckpointPolicy(
        directory=tmp_path, every=every))
    assert torch.equal(part.next_key, sess.run(3, key=key).next_key)
    steps = fault.CheckpointPolicy(tmp_path).manager().all_steps()
    assert steps == ([1, 2, 3] if every == 1 else [2, 3])
    _assert_same(sess.resume(tmp_path, rounds=3), ref)
    # the resume kept checkpointing: a fresh compile of the same problem
    # now restores the finished run
    _assert_same(_session(data, backend=backend).resume(
        CheckpointPolicy(tmp_path)), ref)


def test_snapshots_share_no_storage_with_the_executor_state(
        data, tmp_path, monkeypatch):
    """The payload is cloned on the device at the snapshot point: the
    write lags one period, and an executor may write its state tensors in
    place or hand out views (``finalize``'s w is one)."""
    from repro_torch.runtime.checkpoint import CheckpointManager
    sess = _session(data, Schedule(compression="int8"))
    states, saved = [], []
    real_step = sess.executor.step

    def step(*a, **k):
        states.append(real_step(*a, **k))
        return states[-1]
    real_save = CheckpointManager.save

    def save(self, step_, state, metadata=None):
        saved.append(state)
        return real_save(self, step_, state, metadata)
    monkeypatch.setattr(sess.executor, "step", step)
    monkeypatch.setattr(CheckpointManager, "save", save)
    sess.run(4, key=prng.PRNGKey(1), checkpoint=CheckpointPolicy(
        tmp_path, every=2))
    live = {t.untyped_storage().data_ptr() for st in states
            for t in (st.a, st.w, *st.snapA, *st.snapW, *st.srvW, *st.res)}
    assert [len(p["res"]) for p in saved] == [1, 1]
    for p in saved:
        for t in (p["alpha"], p["w"], *p["res"]):
            assert t.untyped_storage().data_ptr() not in live


def test_async_checkpoint_run_is_the_plain_run(data, tmp_path):
    sess = _session(data)
    ref = sess.run(6, key=prng.PRNGKey(4))
    got = sess.run(6, key=prng.PRNGKey(4), checkpoint=CheckpointPolicy(
        tmp_path, every=1, keep=2, async_save=True))
    _assert_same(got, ref)
    mgr = CheckpointPolicy(tmp_path).manager()
    assert mgr.all_steps() == [5, 6]
    meta = mgr.metadata()
    assert meta["round"] == 6 and meta["rounds_total"] == 6
    assert meta["plan"] == sess.plan.fingerprint
    assert meta["history"] == ref.history


def test_resume_of_completed_run_restores(data, tmp_path):
    """rounds_total is reached: resume is a pure restore (0 extra rounds),
    returning the final iterates and the full recorded history."""
    sess = _session(data)
    key = prng.PRNGKey(3)
    ref = sess.run(6, key=key, checkpoint=CheckpointPolicy(
        directory=tmp_path, every=2))
    res = sess.resume(tmp_path)
    assert torch.equal(res.alpha, ref.alpha)
    assert torch.equal(res.next_key, ref.next_key)
    assert [h["round"] for h in res.history] == \
        [h["round"] for h in ref.history]


@pytest.mark.parametrize("every", [1, 2])
@pytest.mark.parametrize("spec", ["topk_0.2", "int8"])
def test_resume_compressed_plan_carries_residuals(data, spec, every,
                                                  tmp_path):
    """Compressed plans thread error-feedback residuals through the carry;
    the payload holds them, and the resume is bit-identical."""
    sess = _session(data, Schedule(compression=spec))
    key = prng.PRNGKey(11)
    ref = sess.run(6, key=key)
    sess.run(3, key=key, checkpoint=CheckpointPolicy(directory=tmp_path,
                                                     every=every))
    with np.load(tmp_path / "step_0000000003.npz") as z:
        assert sorted(z.files) == ["alpha", "key", "res/0", "w"]
        assert z["res/0"].shape == (4, 8) and z["key"].dtype == np.uint32
        assert np.abs(z["res/0"]).max() > 0
    _assert_same(sess.resume(tmp_path, rounds=3), ref)


def test_resume_refuses_changed_plan(data, tmp_path):
    sess = _session(data)
    sess.run(2, key=prng.PRNGKey(0), checkpoint=str(tmp_path))
    other = _session(data, topo=Topology.star(4, 16, rounds=6,
                                              local_steps=9))
    with pytest.raises(ValueError, match="fingerprint|plan"):
        other.resume(tmp_path)
    with pytest.raises(FileNotFoundError):
        sess.resume(tmp_path / "empty")


def test_checkpoint_refuses_straggler_and_acceleration(data, tmp_path):
    """The reference's refusals, in its order: acceleration with a
    straggler, acceleration with a checkpoint, a checkpoint with a
    straggler."""
    from repro_torch.runtime.straggler import StragglerPolicy
    sess = _session(data)
    with pytest.raises(ValueError, match="straggler"):
        sess.run(2, key=prng.PRNGKey(0), straggler=StragglerPolicy(),
                 checkpoint=str(tmp_path))
    acc = _session(data, Schedule(acceleration=0.5))
    with pytest.raises(ValueError, match="acceleration does not compose "
                                         "with straggler"):
        acc.run(2, straggler=StragglerPolicy(), checkpoint=str(tmp_path))
    with pytest.raises(ValueError, match="acceleration does not compose "
                                         "with checkpoint"):
        acc.run(2, checkpoint=str(tmp_path))
    assert not list(Path(tmp_path).glob("step_*"))


def test_with_ef_residuals_checks_the_plan(data):
    sess = _session(data, Schedule(compression="int8"))
    state = sess.executor.init(sess.problem.X, torch.zeros(64),
                               torch.zeros(8))
    with pytest.raises(ValueError, match="compression"):
        fault.with_ef_residuals(sess, state, [np.zeros((4, 8))] * 2)
    sub = fault.with_ef_residuals(sess, state, [np.ones((4, 8))])
    assert torch.equal(sub.res[0], torch.ones(4, 8))
    # a stand-in session on the mesh backend: its rank holds leaf 2's row
    fake = types.SimpleNamespace(plan=sess.plan, backend="mesh",
                                 device="cpu",
                                 executor=types.SimpleNamespace(leaf=2))
    rows = np.arange(32, dtype=np.float32).reshape(4, 8)
    sub = fault.with_ef_residuals(fake, state, [rows])
    assert torch.equal(sub.res[0], torch.as_tensor(rows[2:3]))
    assert fault.ef_residuals(_session(data), state) == []


# ---------------------------------------------------------------------------
# the Young/Daly period
# ---------------------------------------------------------------------------
def _fault_schedules(mod):
    return [mod.Schedule(rounds="auto", delay=mod.DelayModel(
                t_total=0.2, C=1.0)),
            mod.Schedule(rounds="auto", delay=mod.DelayModel(
                t_total=0.2, C=1.0, mtbf=1.0, ckpt_write=0.01)),
            mod.Schedule(delay=mod.DelayModel(
                t_total=0.2, C=1.0, mtbf=1.0, ckpt_write=0.01)),
            mod.Schedule(rounds="auto", delay=mod.DelayModel(
                t_total=0.5, C=1.0, mtbf=20.0, ckpt_write=0.002))]


def test_ckpt_every_equals_the_reference():
    topo = Topology.star(4, 16, rounds=6, local_steps=8, t_lp=1e-4)
    jtopo = J.Topology.star(4, 16, rounds=6, local_steps=8, t_lp=1e-4)
    got = [s.resolve(topo) for s in _fault_schedules(T)]
    want = [s.resolve(jtopo) for s in _fault_schedules(J)]
    for g, w in zip(got, want, strict=True):
        assert (g.ckpt_every, g.rounds) == (w.ckpt_every, w.rounds)
    assert got[0].ckpt_every is None and got[1].ckpt_every >= 1
    assert got[1].rounds <= got[0].rounds


def test_every_auto_needs_fault_aware_schedule(data, tmp_path):
    sess = _session(data)
    with pytest.raises(ValueError, match="auto"):
        sess.run(2, key=prng.PRNGKey(0),
                 checkpoint=CheckpointPolicy(directory=tmp_path,
                                             every="auto"))
    with pytest.raises(ValueError, match="every"):
        CheckpointPolicy(tmp_path, every="sometimes")
    with pytest.raises(ValueError, match="every"):
        CheckpointPolicy(tmp_path, every=0)
    topo = Topology.star(4, 16, rounds=6, local_steps=8, t_lp=1e-4)
    sched = Schedule(rounds=7, delay=DelayModel(
        t_total=0.2, C=1.0, mtbf=1.0, ckpt_write=0.01))
    planned = Session.compile(_problem(data), topo, sched, backend="torch",
                              device="cpu")
    every = planned.resolved.ckpt_every
    planned.run(key=prng.PRNGKey(0), checkpoint=CheckpointPolicy(
        tmp_path, every="auto", keep=10))
    steps = CheckpointPolicy(tmp_path).manager().all_steps()
    assert steps == sorted({*range(every, 8, every), 7})


# ---------------------------------------------------------------------------
# membership: permanent leave / join
# ---------------------------------------------------------------------------
def _join_block(d, k=12):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(k, d)).astype(np.float32),
            rng.normal(size=(k,)).astype(np.float32))


def test_elastic_leave_join_converges(data):
    """Leaves leave and join mid-solve; each boundary splices the dual and
    rebuilds w = X^T alpha / (lam m); the solve keeps converging on the
    current problem and the final iterates satisfy eq. (13)."""
    Xn, yn = _join_block(data[0].shape[1])
    log = (MembershipLog()
           .leave("W1", at_round=2)
           .join("W9", Xn, yn, at_round=4))
    es = ElasticSession(_problem(data), _star(), backend="torch",
                        device="cpu")
    res = es.run(12, membership=log, key=prng.PRNGKey(1))
    assert es.current_topology.leaf_names() == ["W0", "W2", "W3", "W9"]
    assert es.current_problem.m == 64 - 16 + 12
    assert len(res.alpha) == es.current_problem.m
    w_ref = dual_mod.w_of_alpha(res.alpha, es.current_problem.X, LAM)
    np.testing.assert_allclose(res.w.numpy(), w_ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert [h["round"] for h in res.history][-1] == 12
    gaps = [h["gap"] for h in res.history]
    assert gaps[-1] < gaps[-6]
    assert [d["round"] for d in es.plan_diffs] == [2, 4]
    assert es.plan_diffs[0]["leaves_removed"] == ["W1"]
    assert es.plan_diffs[1]["leaves_added"] == ["W9"]
    assert all(d["fingerprint_changed"] for d in es.plan_diffs)
    # the joined rows sit at the new leaf's span
    off, sz = es.current_topology.leaf_span("W9")
    assert torch.equal(es.current_problem.X[off:off + sz],
                       torch.from_numpy(Xn))


def test_elastic_session_matches_the_reference(data):
    """The same numpy data, events and key through both packages: the
    spliced problems and the plan diffs are equal, the iterates within
    1e-5, the history's round / time axes exact."""
    X, y = data
    Xn, yn = _join_block(X.shape[1])

    def log(mod):
        return (mod.MembershipLog().leave("W1", at_round=2)
                .leave("W3", at_round=2)
                .join("W9", Xn, yn, at_round=3, parent="root"))
    es = ElasticSession(_problem(data), _star(), backend="torch",
                        device="cpu")
    res = es.run(6, membership=log(fault), key=prng.PRNGKey(2))
    jes = J.ElasticSession(J.Problem(X, y, lam=LAM),
                           J.Topology.star(4, 16, rounds=6, local_steps=8),
                           backend="vmap")
    jres = jes.run(6, membership=log(jfault), key=jax.random.PRNGKey(2))
    assert es.plan_diffs == jes.plan_diffs
    assert es.current_topology.to_dict() == jes.current_topology.to_dict()
    np.testing.assert_array_equal(es.current_problem.X.numpy(),
                                  np.asarray(jes.current_problem.X))
    np.testing.assert_allclose(res.alpha.numpy(), np.asarray(jres.alpha),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(res.w.numpy(), np.asarray(jres.w), rtol=0,
                               atol=TOL)
    assert torch.equal(res.next_key, prng.as_key(np.asarray(jres.next_key)))
    assert [(h["round"], h["time"]) for h in res.history] == \
        [(h["round"], h["time"]) for h in jres.history]
    np.testing.assert_allclose(res.gaps, [h["gap"] for h in jres.history],
                               rtol=1e-4, atol=TOL)


def test_elastic_event_at_round_zero_and_no_events(data):
    """An event at round 0 applies before the first round (the run then
    starts from the spliced zero dual with the caller's key); no events is
    a plain run of the compiled session."""
    es = ElasticSession(_problem(data), _star(), backend="torch",
                        device="cpu")
    res = es.run(3, membership=MembershipLog().leave("W0", at_round=0),
                 key=prng.PRNGKey(5))
    sess = Session.compile(
        Problem(_problem(data).X[16:], _problem(data).y[16:], lam=LAM),
        _star().without_leaf("W0"), Schedule(weighting="size"),
        backend="torch", device="cpu")
    ref = sess.run(3, key=prng.PRNGKey(5))
    assert torch.equal(res.alpha, ref.alpha) and torch.equal(res.w, ref.w)
    plain = es.run(2, key=prng.PRNGKey(5))
    assert torch.equal(plain.alpha, Session.compile(
        _problem(data), _star(), Schedule(weighting="size"),
        backend="torch", device="cpu").run(2, key=prng.PRNGKey(5)).alpha)


def test_elastic_reweights_by_size(data):
    """The default schedule re-weights aggregation data-proportionally
    (arXiv:2308.14783): after a leave the surviving leaves' weights
    change, and the spans cover the spliced problem."""
    es = ElasticSession(_problem(data), _star(), backend="torch",
                        device="cpu")
    es.run(3, membership=MembershipLog().leave("W0", at_round=1),
           key=prng.PRNGKey(0))
    assert es.schedule.weighting == "size"
    assert "W0" not in es.current_topology.leaf_names()
    assert es.plan_diffs[0]["weights_changed"]
    sizes = [es.current_topology.leaf_span(nm)[1]
             for nm in es.current_topology.leaf_names()]
    assert sum(sizes) == es.current_problem.m


def test_elastic_event_past_horizon_refused(data):
    es = ElasticSession(_problem(data), _star(), backend="torch",
                        device="cpu")
    with pytest.raises(ValueError, match="never takes effect"):
        es.run(4, membership=MembershipLog().leave("W1", at_round=5),
               key=prng.PRNGKey(0))
    with pytest.raises(ValueError, match=r"X must be \(k, 8\)"):
        es.run(4, membership=MembershipLog().join(
            "W9", np.zeros((3, 5), np.float32), np.zeros(3, np.float32),
            at_round=1), key=prng.PRNGKey(0))
    with pytest.raises(ValueError, match="needs the new leaf"):
        MembershipLog().join("W9", None, None, at_round=1)
    with pytest.raises(ValueError, match="kind"):
        fault.MembershipEvent("move", "W1", 1)


def _edits(mod):
    star = mod.Topology.star(3, 8, rounds=4, local_steps=4)
    two = mod.Topology.two_level(2, 3, 5, root_rounds=3, group_rounds=2,
                                 local_steps=6)
    return [
        star.without_leaf("W1"),
        star.without_leaf("W1").with_leaf("W7", data_size=5),
        two.without_leaf("W00").without_leaf("W01").without_leaf("W02"),
        two.with_leaf("J", parent="S1", data_size=7, local_steps=3,
                      up_delay=0.5, t_lp=1e-3),
        two.without_leaf("W10").with_leaf("J", data_size=4),
    ]


def test_topology_leaf_editing():
    topo = Topology.star(3, 8, rounds=4, local_steps=4)
    assert topo.leaf_names() == ["W0", "W1", "W2"]
    assert topo.leaf_span("W1") == (8, 8)
    smaller = topo.without_leaf("W1")
    assert smaller.leaf_names() == ["W0", "W2"]
    assert smaller.leaf_span("W2") == (8, 8)
    bigger = smaller.with_leaf("W7", data_size=5)
    assert bigger.leaf_names() == ["W0", "W2", "W7"]
    assert bigger.leaf_span("W7") == (16, 5)
    with pytest.raises(KeyError):
        topo.without_leaf("nope")
    with pytest.raises(ValueError):
        bigger.with_leaf("W7", data_size=3)   # duplicate name
    with pytest.raises(KeyError):
        bigger.with_leaf("W8", data_size=3, parent="nowhere")
    with pytest.raises(ValueError):
        Topology.star(1, 8).without_leaf("W0")
    # the edited trees and their plans equal the reference's
    for got, want in zip(_edits(T), _edits(J), strict=True):
        assert got.to_dict() == want.to_dict()
        for weighting in ("uniform", "size"):
            assert tplan.compile_tree(got.tree, weighting=weighting
                                      ).fingerprint == jplan.compile_tree(
                want.tree, weighting=weighting).fingerprint


# ---------------------------------------------------------------------------
# fault injection and fleets
# ---------------------------------------------------------------------------
def test_fault_model_sampling():
    fm = FaultModel(crash_prob=0.5, leave_prob=0.5, min_leaves=2)
    jfm = jfault.FaultModel(crash_prob=0.5, leave_prob=0.5, min_leaves=2)
    c1 = fm.sample_crashes(20, seed=4)
    assert c1 == fm.sample_crashes(20, seed=4)       # deterministic
    assert c1 and all(1 <= t < 20 for t in c1)
    names = ["a", "b", "c", "d"]
    log = fm.sample_leaves(names, 20, seed=4)
    assert len({e.name for e in log.events}) <= 2    # min_leaves respected
    for seed in range(12):
        for prob in (0.1, 0.5, 0.9):
            a = FaultModel(crash_prob=prob, leave_prob=prob, min_leaves=1)
            b = jfault.FaultModel(crash_prob=prob, leave_prob=prob,
                                  min_leaves=1)
            assert a.sample_crashes(15, seed) == b.sample_crashes(15, seed)
            assert [(e.kind, e.name, e.at_round)
                    for e in a.sample_leaves(names, 15, seed).events] == \
                [(e.kind, e.name, e.at_round)
                 for e in b.sample_leaves(names, 15, seed).events]
    assert c1 == jfm.sample_crashes(20, seed=4)
    with pytest.raises(ValueError):
        FaultModel(crash_prob=1.5)
    with pytest.raises(ValueError):
        FaultModel(min_leaves=0)


@pytest.mark.parametrize("compression", [None, "int8"])
def test_run_with_faults_bit_identity(data, compression, tmp_path):
    """Kill-and-resume through the production restart path: crashes strike
    mid-period (every=2) so real work is lost and recomputed, yet the final
    iterates and history equal the uninterrupted run's; the report equals
    the reference's for the same fault model and seed."""
    sess = _session(data, Schedule(compression=compression))
    key = prng.PRNGKey(2)
    ref = sess.run(6, key=key)
    res, report = run_with_faults(
        sess, 6, checkpoint=CheckpointPolicy(directory=tmp_path, every=2),
        fault=FaultModel(crash_prob=0.5), key=key, seed=3)
    assert report["crashes"], report
    _assert_same(res, ref)
    for r in report["restarts"]:
        assert r["resumed_from"] <= r["crash_at"] < r["ran_to"] <= 6
    jsess = J.Session.compile(J.Problem(*data, lam=LAM),
                              J.Topology.star(4, 16, rounds=6,
                                              local_steps=8),
                              J.Schedule(compression=compression),
                              backend="vmap")
    _, jreport = J.run_with_faults(
        jsess, 6, checkpoint=J.CheckpointPolicy(tmp_path / "ref", every=2),
        fault=J.FaultModel(crash_prob=0.5), key=jax.random.PRNGKey(2),
        seed=3)
    assert report == jreport


@pytest.mark.parametrize("layout", ["batched", "sequential"])
def test_sweep_fleet_resume(data, layout, tmp_path):
    """An interrupted checkpointed fleet continues under Sweep(resume=):
    a stateless group snapshots one stacked group_base/ file, a compressed
    one runs member_<i>/ checkpoints; both restart bit-identically (the
    crash: dropping the snapshots after round 4)."""
    lams = [0.05, 0.1, 0.4]
    if layout == "batched":
        sess, spec = _session(data), dict(lams=lams, seeds=[0, 1])
    else:
        sess = _session(data, Schedule(compression="topk_0.2"))
        spec = dict(lams=lams)
    ref = sess.sweep(Sweep(**spec), rounds=6)
    root = tmp_path / layout
    first = sess.sweep(Sweep(**spec), rounds=6,
                       checkpoint=CheckpointPolicy(directory=root, every=1))
    assert torch.equal(first.alphas, ref.alphas)
    assert (root / "fleet.json").exists()
    if layout == "batched":
        assert sorted(p.name for p in root.iterdir()) == \
            ["fleet.json", "group_base"]
        with np.load(root / "group_base" / "step_0000000006.npz") as z:
            assert z["a"].shape == (6, 64) and z["w"].shape == (6, 8)
    else:
        assert sorted(p.name for p in root.glob("member_*")) == \
            ["member_0000", "member_0001", "member_0002"]
    _crash_after(root, 4)
    rs = sess.sweep(Sweep(**spec, resume=root), rounds=6)
    assert torch.equal(rs.alphas, ref.alphas)
    assert torch.equal(rs.ws, ref.ws)
    assert np.array_equal(rs.gaps, ref.gaps)
    assert [torch.equal(a, b) for a, b in
            zip(rs.next_keys, ref.next_keys, strict=True)] == [True] * len(rs)
    # a finished fleet resumes as a restore
    again = sess.sweep(Sweep(**spec, resume=root), rounds=6,
                       checkpoint=CheckpointPolicy(directory=root))
    assert torch.equal(again.ws, ref.ws)


def test_sweep_fleet_continuation_resumes_member_by_member(data, tmp_path):
    sess = _session(data)
    spec = dict(lams=[0.4, 0.1], seeds=[0, 1], continuation=True)
    ref = sess.sweep(Sweep(**spec), rounds=4)
    sess.sweep(Sweep(**spec), rounds=4,
               checkpoint=CheckpointPolicy(tmp_path, every=2))
    assert len(list(tmp_path.glob("member_*"))) == 4
    _crash_after(tmp_path, 2)
    rs = sess.sweep(Sweep(**spec, resume=tmp_path), rounds=4)
    assert torch.equal(rs.alphas, ref.alphas)
    assert torch.equal(rs.ws, ref.ws)


def test_sweep_fleet_resume_refuses_changed_spec(data, tmp_path):
    sess = _session(data)
    sess.sweep(Sweep(lams=[0.1, 0.2]), rounds=4,
               checkpoint=CheckpointPolicy(directory=tmp_path, every=2))
    with pytest.raises(ValueError, match="fleet.json mismatch"):
        sess.sweep(Sweep(lams=[0.3], resume=tmp_path), rounds=4)
    with pytest.raises(ValueError, match="disagree"):
        sess.sweep(Sweep(lams=[0.1, 0.2], resume=tmp_path), rounds=4,
                   checkpoint=CheckpointPolicy(directory=tmp_path / "x"))
    with pytest.raises(ValueError, match="launched for 4 rounds"):
        (tmp_path / "fleet.json").write_text(
            (tmp_path / "fleet.json").read_text().replace('"rounds": 4',
                                                          '"rounds": 5'))
        sess.sweep(Sweep(lams=[0.1, 0.2], resume=tmp_path), rounds=5)


# ---------------------------------------------------------------------------
# one checkpoint format: each package resumes the other's files
# ---------------------------------------------------------------------------
def _jsession(data, compression=None):
    return J.Session.compile(
        J.Problem(*data, lam=LAM),
        J.Topology.star(4, 16, rounds=6, local_steps=8),
        J.Schedule(compression=compression), backend="vmap")


def _close_to_reference(res, jref):
    np.testing.assert_allclose(res.alpha.numpy(), np.asarray(jref.alpha),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(res.w.numpy(), np.asarray(jref.w), rtol=0,
                               atol=TOL)
    assert torch.equal(res.next_key, prng.as_key(np.asarray(jref.next_key)))
    assert [(h["round"], h["time"]) for h in res.history] == \
        [(h["round"], h["time"]) for h in jref.history]


@pytest.mark.parametrize("compression", [None, "topk_0.2"])
def test_the_port_resumes_a_reference_checkpoint(data, compression,
                                                 tmp_path):
    """repro writes a checkpoint after 3 of 6 rounds; the port's
    Session.resume continues it to within 1e-5 of repro's uninterrupted
    run (next_key and the history's round / time exact)."""
    jsess = _jsession(data, compression)
    jref = jsess.run(6, key=jax.random.PRNGKey(7))
    jsess.run(3, key=jax.random.PRNGKey(7),
              checkpoint=J.CheckpointPolicy(directory=tmp_path, every=1))
    sess = _session(data, Schedule(compression=compression))
    assert sess.plan.fingerprint == jsess.plan.fingerprint
    _close_to_reference(sess.resume(tmp_path, rounds=3), jref)


@pytest.mark.parametrize("compression", [None, "topk_0.2"])
def test_the_reference_resumes_a_port_checkpoint(data, compression,
                                                 tmp_path):
    """The reverse: the port writes after 3 of 6 rounds, repro's
    Session.resume continues, within 1e-5 of repro's uninterrupted run."""
    sess = _session(data, Schedule(compression=compression))
    sess.run(3, key=prng.PRNGKey(7),
             checkpoint=CheckpointPolicy(directory=tmp_path, every=2))
    jsess = _jsession(data, compression)
    jref = jsess.run(6, key=jax.random.PRNGKey(7))
    jres = jsess.resume(tmp_path, rounds=3)
    _close_to_reference(SolveResult(
        alpha=torch.from_numpy(np.array(jres.alpha)),
        w=torch.from_numpy(np.array(jres.w)), history=jres.history,
        next_key=prng.as_key(np.asarray(jres.next_key))), jref)
