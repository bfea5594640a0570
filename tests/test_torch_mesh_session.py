"""Sessions on the mesh backend on the CPU: checkpoints and resume across
backends, the deprecated shim, the refusals, and a world of one rank
against the JAX package's one-device mesh session.

One module fixture spawns three processes: two gloo ranks of a 2-leaf
star and, beside them, a world of one rank.  Each runs its cases once
and saves what it got.  Checkpoints cross backends both ways: a host
session's files resume on the mesh, and the mesh's files (written by the
first leaf's rank from the gathered arrays) resume on the host and on
the mesh, each torch.equal to the uninterrupted run; the int8 case
carries its error-feedback residuals through ``with_ef_residuals``.  The
refusals give the JAX package's messages.
"""
import shutil
import types
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.api import (CheckpointPolicy, Problem, Schedule,  # noqa: E402
                             Session, Topology)
from repro_torch.core import dual, prng  # noqa: E402
from repro_torch.core.delay import StragglerModel  # noqa: E402
from repro_torch.core.engine import mesh as tmesh  # noqa: E402
from repro_torch.core.engine import plan as tplan  # noqa: E402
from repro_torch.runtime import ranks  # noqa: E402
from repro_torch.runtime.straggler import StragglerPolicy  # noqa: E402

LAM = 0.1
# the host backend under reduce_scatter (a reassociated sum), and the JAX
# package (the same arithmetic in two libraries)
RS_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
SPAWN_TIMEOUT = 240.0
SCHEDULES = {"plain": None, "int8": "int8"}


def star(n=2, rounds=6):
    return Topology.star(n, 64 // n, rounds=rounds, local_steps=8)


def data(m=64, d=8, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)).astype(np.float32),
            rng.standard_normal(m).astype(np.float32))


def problem():
    X, y = data()
    return Problem(torch.from_numpy(X), torch.from_numpy(y), lam=LAM)


def session(name, backend, n=2, **kw):
    return Session.compile(problem(), star(n),
                           Schedule(compression=SCHEDULES[name]),
                           backend=backend, device="cpu", **kw)


def result(res) -> dict:
    return {"alpha": res.alpha, "w": res.w, "next_key": res.next_key,
            "history": res.history}


def refusal(fn) -> str:
    """The message of the error ``fn`` raises (the refusal under test)."""
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def shim(X, y, mesh):
    from repro_torch.core.treedual_mesh import mesh_tree_dual_solve
    return mesh_tree_dual_solve(
        torch.from_numpy(X), torch.from_numpy(y), mesh,
        loss=dual.get_loss("squared"), lam=LAM, axes=("data",),
        rounds=(6,), local_steps=8, key=prng.PRNGKey(7), device="cpu")


# ---------------------------------------------------------------------------
# the rank programs
# ---------------------------------------------------------------------------
def _pair_cases(root: Path) -> dict:
    from torch.distributed.device_mesh import init_device_mesh
    out = {}
    key = prng.PRNGKey(7)
    for name in SCHEDULES:
        sess = session(name, "mesh")
        # the host's files resume on the mesh
        out[f"host_to_mesh_{name}"] = result(sess.resume(
            root / f"host_{name}", rounds=3))
        # the mesh writes files the host resumes, and files it resumes
        for target in ("host", "mesh"):
            sess.run(3, key=key, checkpoint=CheckpointPolicy(
                root / f"mesh_for_{target}_{name}", every=1))
        out[f"mesh_to_mesh_{name}"] = result(sess.resume(
            root / f"mesh_for_mesh_{name}", rounds=3))
    for sync in tmesh.SYNC_MODES:
        out[f"run_{sync}"] = result(session(
            "plain", "mesh", mesh_sync=sync).run(key=key))
    # a checkpointed fleet on the mesh, and its resume after a crash
    from repro_torch.api import Sweep
    fleet = session("plain", "mesh")
    out["fleet"] = [result(r) for r in fleet.sweep(
        lams=[0.1, 0.01], rounds=4, checkpoint=CheckpointPolicy(
            root / "fleet", every=1))]
    if fleet.writer:                  # the crash: rounds 3 and 4 lost
        for f in (root / "fleet" / "group_base").glob("step_000000000[34].*"):
            f.unlink()
    fleet.barrier()
    out["fleet_resumed"] = [result(r) for r in fleet.sweep(
        Sweep(lams=[0.1, 0.01], resume=root / "fleet"), rounds=4)]
    rs = session("plain", "mesh", mesh_sync="reduce_scatter")
    out["rs_straggler"] = refusal(lambda: rs.run(
        key=key, straggler=StragglerPolicy(model=StragglerModel(), seed=0)))
    out["wrong_world"] = refusal(lambda: Session.compile(
        problem(), Topology.two_level(2, 2, 16), backend="mesh",
        device="cpu"))
    X, y = data()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["shim"] = shim(X, y, init_device_mesh(
            "cpu", (2,), mesh_dim_names=("data",)))
    out["shim_warnings"] = [w.category.__name__ for w in caught
                            if "mesh_tree_dual_solve" in str(w.message)]
    return out


def _rank_main(index, root):
    torch.set_num_threads(1)
    root = Path(root)
    if index < 2:
        ranks.init(index, 2, f"file://{root / 'pg_pair'}")
        out = _pair_cases(root)
    else:
        # a world of its own, of one rank
        ranks.init(0, 1, f"file://{root / 'pg_solo'}")
        out = {"solo": result(session("plain", "mesh", n=1).run(
            rounds=4, key=prng.PRNGKey(3)))}
    torch.save(out, root / f"proc{index}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """(root directory, each process's results); the host checkpoints the
    mesh ranks resume are written first."""
    root = tmp_path_factory.mktemp("mesh_session")
    for name in SCHEDULES:
        session(name, "torch").run(3, key=prng.PRNGKey(7),
                                   checkpoint=CheckpointPolicy(
                                       root / f"host_{name}", every=1))
    ranks.spawn(_rank_main, 3, args=(str(root),), timeout=SPAWN_TIMEOUT)
    return root, [torch.load(root / f"proc{i}.pt", weights_only=False)
                  for i in range(3)]


@pytest.fixture(scope="module")
def got(mesh_run):
    return mesh_run[1][0]


def assert_equal_runs(res: dict, ref):
    assert torch.equal(res["alpha"], ref.alpha)
    assert torch.equal(res["w"], ref.w)
    assert torch.equal(res["next_key"], ref.next_key)
    assert res["history"] == ref.history


def uninterrupted(name):
    return session(name, "torch").run(6, key=prng.PRNGKey(7))


# ---------------------------------------------------------------------------
# resume across backends
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_a_host_checkpoint_resumes_on_the_mesh(got, name):
    assert_equal_runs(got[f"host_to_mesh_{name}"], uninterrupted(name))


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_a_mesh_checkpoint_resumes_on_the_host(mesh_run, name, tmp_path):
    # a copy: the resumed run goes on writing snapshots where it resumed
    shutil.copytree(mesh_run[0] / f"mesh_for_host_{name}", tmp_path / "c")
    res = session(name, "torch").resume(tmp_path / "c", rounds=3)
    assert_equal_runs(result(res), uninterrupted(name))


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_a_mesh_checkpoint_resumes_on_the_mesh(got, name):
    assert_equal_runs(got[f"mesh_to_mesh_{name}"], uninterrupted(name))


def test_the_mesh_writes_the_host_file_format(mesh_run):
    """One payload per snapshot, the int8 root's residual gathered to
    (n, d)."""
    from repro_torch.runtime.checkpoint import CheckpointManager
    mgr = CheckpointManager(
        directory=str(mesh_run[0] / "mesh_for_host_int8"))
    assert mgr.latest_step() == 3
    with np.load(mgr.dir / "step_0000000003.npz") as z:
        assert sorted(z.files) == ["alpha", "key", "res/0", "w"]
        assert z["res/0"].shape == (2, 8) and z["alpha"].shape == (64,)


# ---------------------------------------------------------------------------
# runs against the host backend; both ranks hold the same result
# ---------------------------------------------------------------------------
def test_psum_equals_the_host_and_reduce_scatter_is_close(got):
    ref = session("plain", "torch").run(key=prng.PRNGKey(7))
    assert_equal_runs(got["run_psum"], ref)
    rs = got["run_reduce_scatter"]
    np.testing.assert_allclose(rs["alpha"].numpy(), ref.alpha.numpy(),
                               **RS_TOL)
    np.testing.assert_allclose(rs["w"].numpy(), ref.w.numpy(), **RS_TOL)
    assert torch.equal(rs["next_key"], ref.next_key)


def test_a_mesh_fleet_resumes_bit_for_bit(got):
    """The first leaf's rank writes the fleet's stacked snapshots; after
    the last two are deleted, Sweep(resume=) continues on every rank to
    the uninterrupted members, each its host run."""
    for lam, member, resumed in zip([0.1, 0.01], got["fleet"],
                                    got["fleet_resumed"], strict=True):
        ref = session("plain", "torch").run(4, key=prng.PRNGKey(0), lam=lam)
        assert_equal_runs(member, ref)
        for f in ("alpha", "w", "next_key"):
            assert torch.equal(resumed[f], member[f])
        assert resumed["history"] == member["history"]


def test_both_ranks_return_the_same_results(mesh_run):
    a, b = mesh_run[1][0], mesh_run[1][1]
    for name in ("run_psum", "run_reduce_scatter", "host_to_mesh_int8"):
        assert torch.equal(a[name]["alpha"], b[name]["alpha"])
        assert torch.equal(a[name]["w"], b[name]["w"])
        assert a[name]["history"] == b[name]["history"]


def test_the_deprecated_shim_runs_the_mesh(got):
    assert got["shim_warnings"] == ["DeprecationWarning"]
    tree = tmesh.tree_from_mesh_axes(
        types.SimpleNamespace(mesh_dim_names=("data",), shape=(2,)),
        ("data",), (6,), local_steps=8, m_leaf=32)
    ref = Session.compile(problem(), Topology.from_tree(tree),
                          backend="torch", device="cpu").run(
        key=prng.PRNGKey(7))
    alpha, w = got["shim"]
    assert torch.equal(alpha, ref.alpha) and torch.equal(w, ref.w)


def test_a_world_of_one_rank_against_the_jax_mesh_session(mesh_run):
    """The port's one-rank mesh equals its host backend, and is within
    TOL of the JAX package's mesh session on its one device."""
    import jax

    from repro.api import Problem as JProblem
    from repro.api import Session as JSession
    from repro.api import Topology as JTopology
    solo = mesh_run[1][2]["solo"]
    assert_equal_runs(solo, session("plain", "torch", n=1).run(
        rounds=4, key=prng.PRNGKey(3)))
    X, y = data()
    ref = JSession.compile(
        JProblem(X, y, lam=LAM),
        JTopology.star(1, 64, rounds=6, local_steps=8),
        backend="mesh").run(rounds=4, key=jax.random.PRNGKey(3))
    np.testing.assert_allclose(solo["alpha"].numpy(), np.asarray(ref.alpha),
                               **TOL)
    np.testing.assert_allclose(solo["w"].numpy(), np.asarray(ref.w), **TOL)
    np.testing.assert_allclose([h["gap"] for h in solo["history"]],
                               [h["gap"] for h in ref.history], **TOL)


# ---------------------------------------------------------------------------
# refusals, with the JAX package's messages
# ---------------------------------------------------------------------------
def test_refusals_on_the_ranks(got):
    assert got["rs_straggler"] == (
        "ValueError: mesh_sync='reduce_scatter' assumes full participation "
        "(the sharded-server sync has no per-leaf gating); use "
        "mesh_sync='psum' for straggler-adaptive runs")
    # the counterpart of the reference's "needs 4 devices"
    assert got["wrong_world"].startswith(
        "RuntimeError: backend='mesh' needs 4 ranks (one per leaf) for "
        "fan-outs [2, 2], have world size 2")


def _same_message(port_fn, ref_fn):
    with pytest.raises(ValueError) as want:
        ref_fn()
    with pytest.raises(ValueError) as have:
        port_fn()
    assert str(have.value) == str(want.value)


def test_session_refusals_give_the_reference_messages():
    from repro.api import Problem as JProblem
    from repro.api import Schedule as JSchedule
    from repro.api import Session as JSession
    from repro.api import Topology as JTopology
    groups = [[16, 16], [8, 16, 16]]
    X, y = data(m=72)
    _same_message(
        lambda: Session.compile(
            Problem(torch.from_numpy(X), torch.from_numpy(y)),
            Topology.groups(groups), backend="mesh", device="cpu"),
        lambda: JSession.compile(JProblem(X, y), JTopology.groups(groups),
                                 backend="mesh"))
    X, y = data()
    jstar = JTopology.star(2, 32, rounds=6, local_steps=8)
    _same_message(
        lambda: Session.compile(problem(), star(),
                                Schedule(weighting="size"), backend="mesh",
                                device="cpu"),
        lambda: JSession.compile(JProblem(X, y), jstar,
                                 JSchedule(weighting="size"),
                                 backend="mesh"))
    _same_message(
        lambda: Session.compile(problem(), star(), backend="mesh",
                                device="cpu", mesh_sync="ring"),
        lambda: JSession.compile(JProblem(X, y), jstar, backend="mesh",
                                 mesh_sync="ring"))
    with pytest.raises(ValueError, match="pass mesh_axes"):
        Session.compile(problem(), star(), backend="mesh", device="cpu",
                        mesh=types.SimpleNamespace())
    # without a process group: the ranks it needs, as the reference names
    # the devices it needs
    with pytest.raises(RuntimeError, match="needs 2 ranks .* have no "
                                           "process group"):
        Session.compile(problem(), star(), backend="mesh", device="cpu")


def test_plan_checks_give_the_reference_messages():
    from repro.api import Topology as JTopology
    from repro.core.engine import mesh as jmesh
    from repro.core.engine import plan as jplan
    from repro.launch.mesh import make_abstract_mesh

    def plans(jt, weighting="uniform"):
        tt = Topology.from_json(jt.to_json())
        return (tplan.compile_tree(tt.tree, weighting=weighting),
                jplan.compile_tree(jt.tree, weighting=weighting))

    cases = [  # (plans, mesh shape, mesh names, axes)
        (plans(JTopology.groups([[8, 8], [8, 8, 8]])), (2,), ("a",),
         ("a",)),
        (plans(JTopology.two_level(2, 2, 8), "size"), (2, 2), ("a", "b"),
         ("b", "a")),
        (plans(JTopology.two_level(2, 2, 8)), (4,), ("a",), ("a",)),
        (plans(JTopology.two_level(2, 3, 8)), (2, 2), ("a", "b"),
         ("b", "a")),
    ]
    for (tp, jp), shape, names, axes in cases:
        with pytest.raises(AssertionError) as want:
            jmesh._check_plan_mesh(jp, make_abstract_mesh(shape, names),
                                   axes)
        with pytest.raises(ValueError) as have:
            tmesh._check_plan_mesh(
                tp, types.SimpleNamespace(mesh_dim_names=names,
                                          shape=shape), axes)
        assert str(have.value) == str(want.value)
    # one compression spec per depth: S0's up-link int8, S1's exact
    tp, jp = plans(JTopology.two_level(2, 2, 8).with_compression(
        "int8", names=["S0"]))
    with pytest.raises(ValueError) as want:
        jmesh._comp_specs(jp)
    with pytest.raises(ValueError) as have:
        tmesh._comp_specs(tp)
    assert str(have.value) == str(want.value)
    assert "depth 0 mixes ['int8', 'none']" in str(have.value)
