"""The mesh backend (core/engine/mesh.py) on the CPU: four gloo ranks, one
per leaf of a 2 x 2 tree, spawned once for the module.  Each rank runs
every case below and saves what it got; the tests then hold it

  * to the port's host backend on the same problem, topology, schedule and
    key: torch.equal under the psum lowering (alpha, w, next_key and the
    history), for plain, logistic, straggler-masked, accelerated and
    int8-compressed runs and for sweep members; within rtol 1e-5 / atol
    1e-6 under reduce_scatter (the sum is reassociated);
  * to the JAX package's mesh program (get_mesh_executor) on 4 emulated
    CPU devices, run in a child process, within the session tests' TOL,
    under both lowerings;
  * and to the JAX package exactly where the answer is an integer or a
    structure: mesh_state_floats, tree_from_mesh_axes, Topology.from_mesh
    and fold_batch on a DeviceMesh.

The rank program is this module's ``_rank_main``; the spawned processes
import this file, so nothing at its top level imports JAX.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.api import Problem, Schedule, Session, Topology  # noqa: E402
from repro_torch.core import dual, prng  # noqa: E402
from repro_torch.core.delay import StragglerModel  # noqa: E402
from repro_torch.core.engine import host as thost  # noqa: E402
from repro_torch.core.engine import mesh as tmesh  # noqa: E402
from repro_torch.core.engine import plan as tplan  # noqa: E402
from repro_torch.runtime import ranks  # noqa: E402
from repro_torch.runtime.straggler import StragglerPolicy  # noqa: E402

LAM = 0.1
WORLD = 4
# the host backend under the reduce_scatter lowering: the group sum is
# reassociated (tests/test_compression.py's tolerance for the same claim)
RS_TOL = dict(rtol=1e-5, atol=1e-6)
# against the JAX package: the same arithmetic in two libraries
TOL = dict(rtol=1e-4, atol=1e-5)
SPAWN_TIMEOUT = 240.0
STRAGGLER_MODEL = dict(slow_prob=0.3, slow_factor=30.0, jitter=0.02)
SWEEP = dict(lams=[0.1, 0.01], seeds=[0, 1])
ROOT = Path(__file__).resolve().parents[1]


def topo() -> Topology:
    return Topology.two_level(2, 2, 40, root_rounds=5, group_rounds=3,
                              local_steps=60)


def straggler_topo() -> Topology:
    """tests/test_torch_straggler.py's two-level tree: its link delays
    let the policy drop leaves."""
    return Topology.two_level(2, 2, 32, root_rounds=12, group_rounds=2,
                              local_steps=32, t_lp=1e-5, root_delay=0.02,
                              group_delay=1e-3)


def data(m, d=12, seed=0, labels=False):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((m, d)).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    if labels:
        y = np.where(y >= 0, 1.0, -1.0).astype(np.float32)
    return X, y


def problem(d=12, labels=False, loss="squared", m=None):
    X, y = data(m or topo().m_total, d=d, labels=labels)
    return Problem(torch.from_numpy(X), torch.from_numpy(y), loss=loss,
                   lam=LAM)


def policy():
    return StragglerPolicy(model=StragglerModel(**STRAGGLER_MODEL),
                           max_consecutive=2, seed=1)


def result(res) -> dict:
    return {"alpha": res.alpha, "w": res.w, "next_key": res.next_key,
            "history": res.history}


# ---------------------------------------------------------------------------
# the rank program
# ---------------------------------------------------------------------------
def _mesh_session(prob, schedule=None, tree=None, **kw):
    return Session.compile(prob, tree or topo(), schedule, backend="mesh",
                           device="cpu", **kw)


def _cases() -> dict:
    from torch.distributed.device_mesh import init_device_mesh
    out = {}
    key = prng.PRNGKey(3)
    for use_kernel in (True, False):
        out[f"psum_kernel={use_kernel}"] = result(_mesh_session(
            problem(), mesh_use_kernel=use_kernel).run(key=key))
    # an explicit mesh whose first dimension is the leaf level: leaf i of
    # the tree is not rank i, and the root group gathers in a new order
    inner_first = init_device_mesh("cpu", (2, 2),
                                   mesh_dim_names=("inner", "outer"))
    out["permuted_mesh"] = result(_mesh_session(
        problem(), mesh=inner_first, mesh_axes=("inner", "outer")).run(
            key=key))
    out["permuted_leaf_ranks"] = tmesh.leaf_ranks(inner_first,
                                                  ("inner", "outer"))
    out["logistic"] = result(_mesh_session(
        problem(labels=True, loss="logistic")).run(
            rounds=3, key=prng.PRNGKey(1)))
    st = straggler_topo()
    out["straggler"] = result(_mesh_session(
        problem(m=st.m_total), tree=st).run(key=prng.PRNGKey(0),
                                            straggler=policy()))
    acc = _mesh_session(problem(), Schedule(acceleration=0.5))
    out["accel_0"] = result(acc.run(key=key, acceleration=0.0))
    out["accel_0.5"] = result(acc.run(key=key))
    for sync in tmesh.SYNC_MODES:
        out[f"int8_{sync}"] = result(_mesh_session(
            problem(), Schedule(compression="int8"),
            mesh_sync=sync).run(key=key))
    out["rs_d37"] = result(_mesh_session(
        problem(d=37), mesh_sync="reduce_scatter").run(key=key))
    sess = _mesh_session(problem())
    rs = sess.sweep(**SWEEP)
    out["sweep"] = [result(r) for r in rs]
    out["sweep_standalone"] = [
        result(sess.run(key=prng.PRNGKey(pt.seed), lam=pt.lam))
        for pt in rs.points]
    # the engine entry point on the full tree, for the JAX package's mesh
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("lvl0", "lvl1"))
    tree = topo().tree
    plan = tplan.compile_tree(tree)
    X, y = data(plan.m_total)
    for sync in tmesh.SYNC_MODES:
        out[f"engine_{sync}"] = tmesh.execute_plan_mesh(
            plan, tree, torch.from_numpy(X), torch.from_numpy(y), mesh,
            axes=("lvl1", "lvl0"), loss=dual.get_loss("squared"), lam=LAM,
            key=key, sync=sync)
    # structures read off a DeviceMesh
    dm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    out["from_mesh"] = [
        Topology.from_mesh(dm).to_dict(),
        Topology.from_mesh(dm, periods=[8, 3], level_delays=[1e-4, 5e-2],
                           t_lp=1e-6, m_leaf=16).to_dict(),
        Topology.from_mesh(dm, sync_axes=("data",)).to_dict()]
    out["tree_from_mesh_axes"] = Topology.from_tree(tmesh.tree_from_mesh_axes(
        dm, ("data", "pod"), (3, 5), local_steps=7, m_leaf=9)).to_dict()
    from repro_torch.runtime import elastic
    out["fold_batch"] = elastic.fold_batch(64, dm)
    out["leaf_ranks"] = [tmesh.leaf_ranks(dm, ("data", "pod")),
                         tmesh.leaf_ranks(dm, ("pod", "data"))]
    out["cache_stats"] = tmesh.mesh_executor_cache_stats()
    out["cache_keys"] = tmesh.mesh_executor_cache_keys()
    return out


def _rank_main(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    ranks.init(rank, world, f"file://{init_file}")
    out = _cases()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX package's mesh program, in a child with 4 emulated devices
# ---------------------------------------------------------------------------
def _reference_program(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.api import Topology as JTopology
    from repro.core.dual import get_loss
    from repro.core.engine import mesh as jmesh
    from repro.core.engine import plan as jplan
    from repro.core.engine.host import regularizer_scale
    tree = JTopology.two_level(2, 2, 40, root_rounds=5, group_rounds=3,
                               local_steps=60).tree
    plan = jplan.compile_tree(tree)
    n, m_b = plan.n_leaves, plan.m_b
    X, y = data(plan.m_total)
    mesh = jax.make_mesh((2, 2), ("lvl0", "lvl1"),
                         devices=jax.devices()[:4])
    axes = ("lvl1", "lvl0")
    sh = NamedSharding(mesh, P(tuple(reversed(axes))))
    keys = jplan.key_plan(tree, plan, jax.random.PRNGKey(3))
    args = (jax.device_put(jnp.asarray(X).reshape(n, m_b, -1), sh),
            jax.device_put(jnp.asarray(y).reshape(n, m_b), sh),
            jnp.zeros((n, m_b), jnp.float32),
            jnp.zeros((X.shape[1],), jnp.float32),
            jax.device_put(jnp.asarray(keys.transpose(1, 0, 2)), sh),
            jax.device_put(jnp.asarray(
                jplan.full_participation(plan), jnp.float32).T, sh),
            jax.device_put(jnp.asarray(
                jplan.full_steps(plan).transpose(1, 0, 2), jnp.float32), sh),
            regularizer_scale(LAM, plan.m_total, jnp.float32))
    got = {}
    for sync in jmesh.SYNC_MODES:
        fn = jmesh.get_mesh_executor(plan, mesh, axes=axes,
                                     loss=get_loss("squared"),
                                     use_kernel=False, sync=sync)
        alpha, wrows = fn(*args)
        got[f"{sync}_alpha"] = np.asarray(alpha).reshape(-1)
        got[f"{sync}_w"] = np.asarray(wrows)[0]
    np.savez(out_path, **got)


def _start_reference(out_path: Path) -> subprocess.Popen:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_mesh as t; t._reference_program(sys.argv[2])")
    return subprocess.Popen(
        [sys.executable, "-c", code, str(Path(__file__).parent),
         str(out_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, start_new_session=True)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """(rank results, the JAX package's mesh results): the ranks and the
    reference child run at the same time."""
    root = tmp_path_factory.mktemp("mesh")
    ref_path = root / "reference.npz"
    child = _start_reference(ref_path)
    try:
        ranks.spawn(_rank_main, WORLD, args=(WORLD, str(root / "pg"),
                                             str(root)),
                    timeout=SPAWN_TIMEOUT)
        log, _ = child.communicate(timeout=SPAWN_TIMEOUT)
    finally:
        if child.poll() is None:
            os.killpg(child.pid, 9)
            child.wait()
    assert child.returncode == 0, log.decode(errors="replace")[-4000:]
    got = [torch.load(root / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    return got, dict(np.load(ref_path))


@pytest.fixture(scope="module")
def got(mesh_run):
    return mesh_run[0][0]


def host_session(prob, schedule=None, tree=None):
    return Session.compile(prob, tree or topo(), schedule, backend="torch",
                           device="cpu")


def assert_equal_runs(res: dict, ref):
    assert torch.equal(res["alpha"], ref.alpha)
    assert torch.equal(res["w"], ref.w)
    assert torch.equal(res["next_key"], ref.next_key)
    assert res["history"] == ref.history


def assert_close_runs(res: dict, ref, tol=RS_TOL):
    np.testing.assert_allclose(res["alpha"].numpy(), ref.alpha.numpy(),
                               **tol)
    np.testing.assert_allclose(res["w"].numpy(), ref.w.numpy(), **tol)
    assert torch.equal(res["next_key"], ref.next_key)
    for f in ("dual", "primal"):
        np.testing.assert_allclose([h[f] for h in res["history"]],
                                   [h[f] for h in ref.history], **tol)


# ---------------------------------------------------------------------------
# psum: the host backend bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_kernel", [True, False])
def test_psum_mesh_equals_the_host_backend(got, use_kernel):
    ref = host_session(problem()).run(key=prng.PRNGKey(3))
    assert_equal_runs(got[f"psum_kernel={use_kernel}"], ref)


def test_a_mesh_whose_ranks_are_not_in_leaf_order(got):
    """Ranks 1 and 2 hold leaves 2 and 1: the gathers put the rows back
    in leaf order, so the run still equals the host backend."""
    assert got["permuted_leaf_ranks"] == [0, 2, 1, 3]
    assert_equal_runs(got["permuted_mesh"],
                      host_session(problem()).run(key=prng.PRNGKey(3)))


def test_psum_mesh_equals_the_host_backend_logistic(got):
    ref = host_session(problem(labels=True, loss="logistic")).run(
        rounds=3, key=prng.PRNGKey(1))
    assert_equal_runs(got["logistic"], ref)


def test_every_rank_returns_the_same_result(mesh_run):
    per_rank = mesh_run[0]
    for other in per_rank[1:]:
        for name in ("psum_kernel=True", "straggler", "int8_psum"):
            a, b = per_rank[0][name], other[name]
            assert torch.equal(a["alpha"], b["alpha"])
            assert torch.equal(a["w"], b["w"])
            assert a["history"] == b["history"]


def test_straggler_masks_on_the_mesh_equal_the_host_backend(got):
    st = straggler_topo()
    ref = host_session(problem(m=st.m_total), tree=st).run(
        key=prng.PRNGKey(0), straggler=policy())
    parts = [h["participants"] for h in ref.history[1:]]
    assert min(parts) < 4 and parts[-1] == 4         # some chunk dropped
    assert_equal_runs(got["straggler"], ref)


def test_acceleration_on_the_mesh(got):
    """acceleration=0 is the plain mesh run; 0.5 is the host's
    accelerated run."""
    plain = got["psum_kernel=True"]
    for f in ("alpha", "w", "next_key"):
        assert torch.equal(got["accel_0"][f], plain[f])
    assert got["accel_0"]["history"] == plain["history"]
    ref = host_session(problem(), Schedule(acceleration=0.5)).run(
        key=prng.PRNGKey(3))
    assert_equal_runs(got["accel_0.5"], ref)


def test_int8_compressed_psum_mesh_equals_the_host_backend(got):
    ref = host_session(problem(), Schedule(compression="int8")).run(
        key=prng.PRNGKey(3))
    assert_equal_runs(got["int8_psum"], ref)


def test_mesh_sweep_members_equal_standalone_mesh_runs(got):
    assert len(got["sweep"]) == 4
    for member, alone in zip(got["sweep"], got["sweep_standalone"],
                             strict=True):
        for f in ("alpha", "w", "next_key"):
            assert torch.equal(member[f], alone[f])
        assert member["history"] == alone["history"]


# ---------------------------------------------------------------------------
# reduce_scatter: the host backend up to reassociation
# ---------------------------------------------------------------------------
def test_reduce_scatter_with_padded_shards_is_close_to_the_host(got):
    ref = host_session(problem(d=37)).run(key=prng.PRNGKey(3))
    assert_close_runs(got["rs_d37"], ref)


def test_reduce_scatter_compressed_is_close_to_the_host(got):
    ref = host_session(problem(), Schedule(compression="int8")).run(
        key=prng.PRNGKey(3))
    assert_close_runs(got["int8_reduce_scatter"], ref)


# ---------------------------------------------------------------------------
# the engine entry point against the host executor and the JAX package
# ---------------------------------------------------------------------------
def _engine_host():
    tree = topo().tree
    plan = tplan.compile_tree(tree)
    X, y = data(plan.m_total)
    keys = tplan.key_plan(tree, plan, prng.PRNGKey(3))
    return thost.execute_plan(plan, torch.from_numpy(X), torch.from_numpy(y),
                              keys, loss=dual.get_loss("squared"), lam=LAM,
                              backend="torch")


def test_execute_plan_mesh_against_the_host_executor(got):
    a_ref, w_ref = _engine_host()
    a, w = got["engine_psum"]
    assert torch.equal(a, a_ref) and torch.equal(w, w_ref)
    a, w = got["engine_reduce_scatter"]
    np.testing.assert_allclose(a.numpy(), a_ref.numpy(), **RS_TOL)
    np.testing.assert_allclose(w.numpy(), w_ref.numpy(), **RS_TOL)


@pytest.mark.parametrize("sync", ["psum", "reduce_scatter"])
def test_mesh_matches_the_jax_mesh_program_on_4_devices(mesh_run, sync):
    got, ref = mesh_run[0][0], mesh_run[1]
    a, w = got[f"engine_{sync}"]
    np.testing.assert_allclose(a.numpy(), ref[f"{sync}_alpha"], **TOL)
    np.testing.assert_allclose(w.numpy(), ref[f"{sync}_w"], **TOL)


def test_mesh_executor_cache(got):
    stats = got["cache_stats"]
    assert stats["misses"] == len(got["cache_keys"]) == stats["size"]
    assert stats["hits"] > 0             # the sweep's standalone runs
    keys = got["cache_keys"]
    assert all(tuple(k) == tmesh.MESH_KEY_FIELDS for k in keys)
    assert {k["sync"] for k in keys} == set(tmesh.SYNC_MODES)
    assert any(k["batched"] for k in keys) and \
        any(k["accelerated"] for k in keys)


# ---------------------------------------------------------------------------
# exact: integers and structures
# ---------------------------------------------------------------------------
def _jax_plans():
    from repro.api import Schedule as JSchedule
    from repro.api import Topology as JTopology
    from repro.core.engine import plan as jplan
    cases = [(JTopology.two_level(2, 2, 40), None),
             (JTopology.balanced([2, 3, 2], m_leaf=16), None),
             (JTopology.two_level(2, 4, 16), "int8"),
             (JTopology.balanced([3, 2], m_leaf=8), ["topk_0.25", "int8"])]
    for jt, comp in cases:
        resolved = JSchedule(compression=comp).resolve(jt)
        yield jt, comp, jplan.compile_tree(
            resolved.chunk_tree, weighting=resolved.weighting,
            compression=resolved.compression)


@pytest.mark.parametrize("d_feat", [1, 7, 37, 512])
def test_mesh_state_floats_equal_the_reference(d_feat):
    from repro.core.engine import mesh as jmesh
    for jt, comp, jp in _jax_plans():
        tt = Topology.from_json(jt.to_json())
        resolved = Schedule(compression=comp).resolve(tt)
        tp = tplan.compile_tree(resolved.chunk_tree,
                                weighting=resolved.weighting,
                                compression=resolved.compression)
        for sync in tmesh.SYNC_MODES:
            assert tmesh.mesh_state_floats(tp, d_feat, sync=sync) == \
                jmesh.mesh_state_floats(jp, d_feat, sync=sync)
    with pytest.raises(ValueError, match="sync must be one of"):
        tmesh.mesh_state_floats(tp, 8, sync="ring")


def _abstract(shape, names):
    from repro.launch.mesh import make_abstract_mesh
    return make_abstract_mesh(shape, names)


def test_structures_on_a_device_mesh_equal_the_reference(got):
    from repro.api import Topology as JTopology
    from repro.core.engine import mesh as jmesh
    from repro.runtime import elastic as jelastic
    jm = _abstract((2, 2), ("pod", "data"))
    assert got["from_mesh"] == [
        JTopology.from_mesh(jm).to_dict(),
        JTopology.from_mesh(jm, periods=[8, 3], level_delays=[1e-4, 5e-2],
                            t_lp=1e-6, m_leaf=16).to_dict(),
        JTopology.from_mesh(jm, sync_axes=("data",)).to_dict()]
    assert got["tree_from_mesh_axes"] == JTopology.from_tree(
        jmesh.tree_from_mesh_axes(jm, ("data", "pod"), (3, 5),
                                  local_steps=7, m_leaf=9)).to_dict()
    assert got["fold_batch"] == jelastic.fold_batch(64, jm)
    # the leaf axis runs over the axes top-down (innermost last): with
    # "data" innermost the leaves are pod-major, else data-major
    assert got["leaf_ranks"] == [[0, 1, 2, 3], [0, 2, 1, 3]]
