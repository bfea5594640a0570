"""The LM sweep (api/lm.py::LMSession.sweep, core/engine/lm.py::
BatchedLMStep) on the CPU: four gloo ranks, one per replica of a (pod,
data) = (2, 2) mesh, spawned once for the module, against the JAX
package's ``LMSession.sweep`` on 4 emulated CPU devices in a child
process.

Both packages draw every member's weights from its own seed
(``PRNGKey(seed)``; the port's draws are the reference's within a few
float32 ulp), so no state is carried across.  The tests hold

  * one executor build per grid, a repeated grid all hits, the (4, 4)
    loss history and ``best()`` (the reference's
    ``tests/test_lm_session.py::test_sweep_one_executor_per_grid``);
  * every member's losses, params and optimizer state to the reference's
    LMRunSet member within TOL;
  * every member torch.equal to its standalone ``LMSession.run`` on the
    same ranks, for the (lr x seed) grid and for an int8-root grid over
    (seed x local_h);
  * one data draw per step for the whole grid;
  * the refusals of SDCA-only axes, message for message.

The rank program is this module's ``_rank_main``; the spawned processes
import this file, so nothing at its top level imports JAX.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.api import (LMRunSet, Problem, Schedule, Session,  # noqa: E402
                             Sweep, Topology)
from repro_torch.api.convert import lm_state_from_reference  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.engine import lm as tlm  # noqa: E402
from repro_torch.optim import make_sgd  # noqa: E402
from repro_torch.optim.api import tree_leaves  # noqa: E402
from repro_torch.runtime import ranks  # noqa: E402

WORLD = 4
# against the JAX package: the same f32 arithmetic in two libraries, from
# initial weights that agree to a few ulp (tests/test_torch_lm_session.py)
TOL = dict(rtol=1e-4, atol=1e-5)
SPAWN_TIMEOUT = 300.0
ROOT = Path(__file__).resolve().parents[1]
CFG_KW = dict(name="tiny", family="dense", num_layers=2, d_model=32,
              num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64,
              vocab_size=64, q_chunk_size=16, logits_chunk=16, remat=False,
              activation_dtype="float32")
BATCH, SEQ, STEPS = 8, 16, 4
LRS, SEEDS = [0.01, 0.05], [0, 1]
SGD = dict(lr=0.05, momentum=0.9)
# the int8-root grid: seeds x local_h at the optimizer's own lr
H_SEEDS, H_LOCAL = [0, 3], [1, 2]


# ---------------------------------------------------------------------------
# the rank program
# ---------------------------------------------------------------------------
def _session(mesh, compression=None):
    prob = Problem.lm(ModelConfig(**CFG_KW), make_sgd(**SGD), batch=BATCH,
                      seq=SEQ, seed=0)
    topo = Topology.from_mesh(mesh, sync_axes=("data", "pod"),
                              periods=(2, 2))
    return Session.compile(prob, topo, Schedule(compression=compression),
                           backend="mesh", mesh=mesh, device="cpu")


def _own(state) -> dict:
    return {"params": [t.clone() for t in tree_leaves(state.params)],
            "opt": [t.clone() for t in tree_leaves(state.opt_state)],
            "residual": [t.clone() for t in tree_leaves(state.residual)]
            if state.residual is not None else []}


def _equal(a: dict, b: dict) -> bool:
    return all(torch.equal(x, y) for k in ("params", "opt", "residual")
               for x, y in zip(a[k], b[k], strict=True))


def _cases(root: Path) -> dict:
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 2, 1),
                            mesh_dim_names=("pod", "data", "model"))
    out = {}
    sess = _session(mesh)
    tlm.clear_lm_executor_cache()
    s0 = sess.cache_stats()
    draws0 = sess.draw_count
    rs = sess.sweep(Sweep(lrs=LRS, seeds=SEEDS), steps=STEPS)
    s1 = sess.cache_stats()
    out["draws"] = sess.draw_count - draws0
    sess.sweep(Sweep(lrs=LRS, seeds=SEEDS), steps=2)
    s2 = sess.cache_stats()
    out["cache"] = [s0, s1, s2]
    out["type"] = type(rs).__name__
    out["len"] = len(rs)
    out["losses"] = rs.losses
    out["best"] = rs.best()
    out["final"] = rs.final_losses
    out["points"] = [(p.lr, p.seed, p.local_h) for p in rs.points]
    out["lrs"] = rs.lrs
    out["replica"] = sess.replica
    out["members"] = [_own(rs.member_state(i)) for i in range(len(rs))]
    out["standalone"] = []
    for i, pt in enumerate(rs.points):
        one = sess.run(steps=STEPS, key=pt.seed, lr=pt.lr)
        out["standalone"].append({
            "equal": _equal(_own(one.state), out["members"][i]),
            "losses": [h["loss"] for h in one.history]})

    # int8 root, local_h x seed: every member its standalone run
    s8 = _session(mesh, ("int8", "none"))
    rs8 = s8.sweep(seeds=H_SEEDS, local_hs=H_LOCAL, steps=STEPS)
    out["int8"] = []
    for i, pt in enumerate(rs8.points):
        one = s8.run(steps=STEPS, key=pt.seed, local_h=pt.local_h)
        out["int8"].append({
            "point": (pt.seed, pt.local_h),
            "equal": _equal(_own(one.state), _own(rs8.member_state(i))),
            "losses": [h["loss"] for h in one.history] ==
            rs8.losses[i].tolist()})
    return out


def _rank_main(rank, world, root):
    torch.set_num_threads(1)
    root = Path(root)
    ranks.init(rank, world, f"file://{root / 'pg'}")
    out = _cases(root)
    torch.save(out, root / f"rank{rank}.pt")
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX package's LMSession.sweep, in a child with 4 emulated devices
# ---------------------------------------------------------------------------
def _reference_program(root):
    import jax

    from repro.api import Problem as JProblem
    from repro.api import Session as JSession
    from repro.api import Sweep as JSweep
    from repro.api import Topology as JTopology
    from repro.configs.base import ModelConfig as JConfig
    from repro.optim import make_sgd as jsgd
    mesh = jax.make_mesh((2, 2, 1), ("pod", "data", "model"),
                         devices=jax.devices()[:4])
    prob = JProblem.lm(JConfig(**CFG_KW), jsgd(**SGD), batch=BATCH,
                       seq=SEQ, seed=0)
    topo = JTopology.from_mesh(mesh, sync_axes=("data", "pod"),
                               periods=(2, 2))
    sess = JSession.compile(prob, topo, backend="mesh", mesh=mesh)
    rs = sess.sweep(JSweep(lrs=LRS, seeds=SEEDS), steps=STEPS)
    out = {"losses": np.asarray(rs.losses),
           "points": [(p.lr, p.seed, p.local_h) for p in rs.points],
           "states": {"params": jax.tree.map(np.asarray, rs.states.params),
                      "opt_state": jax.tree.map(np.asarray,
                                                rs.states.opt_state),
                      "step": np.asarray(rs.states.step)}}
    with open(Path(root) / "reference.pkl", "wb") as f:
        pickle.dump(out, f)


def _run_reference(fn: str, root: Path) -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            f"import test_torch_lm_sweep as t; t.{fn}(sys.argv[2])")
    child = subprocess.Popen(
        [sys.executable, "-c", code, str(Path(__file__).parent), str(root)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        start_new_session=True)
    try:
        log, _ = child.communicate(timeout=SPAWN_TIMEOUT)
    finally:
        if child.poll() is None:
            os.killpg(child.pid, 9)
            child.wait()
    assert child.returncode == 0, log.decode(errors="replace")[-4000:]


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """(rank results, the reference's results)."""
    root = tmp_path_factory.mktemp("lm_sweep")
    _run_reference("_reference_program", root)
    ranks.spawn(_rank_main, WORLD, args=(WORLD, str(root)),
                timeout=SPAWN_TIMEOUT)
    got = [torch.load(root / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    with open(root / "reference.pkl", "rb") as f:
        ref = pickle.load(f)
    return got, ref


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **TOL)


def _member_of(ref, b: int, replica: int):
    """Member b, replica ``replica`` of the reference's stacked states."""
    import jax
    one = {"params": jax.tree.map(lambda t: t[b], ref["states"]["params"]),
           "opt_state": jax.tree.map(lambda t: t[b],
                                     ref["states"]["opt_state"]),
           "step": ref["states"]["step"][b]}
    st = lm_state_from_reference(one, replica, device="cpu")
    return tree_leaves(st.params), tree_leaves(st.opt_state)


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------
def test_sweep_one_executor_per_grid(swept):
    """One build for the (lr x seed) grid, a repeat grid all hits, the
    (B, T) float32 losses and a best() among the lrs."""
    for g in swept[0]:
        s0, s1, s2 = g["cache"]
        assert s1["misses"] - s0["misses"] == 1
        assert s2["misses"] == s1["misses"]
        assert g["type"] == "LMRunSet" and g["len"] == 4
        assert g["losses"].shape == (4, STEPS)
        assert g["losses"].dtype == np.float32
        assert np.isfinite(g["losses"]).all()
        assert np.array_equal(g["final"], g["losses"][:, -1])
        i = g["best"]
        assert 0 <= i < 4 and g["points"][i][0] in LRS
        assert i == int(np.nanargmin(g["losses"][:, -1]))
        assert g["lrs"] == [p[0] for p in g["points"]]


def test_points_are_the_references(swept):
    got, ref = swept
    assert got[0]["points"] == [tuple(p) for p in ref["points"]]
    assert got[0]["points"] == [(lr, s, None) for lr in LRS for s in SEEDS]


def test_one_data_draw_per_step_for_the_grid(swept):
    for g in swept[0]:
        assert g["draws"] == STEPS


def test_losses_match_the_references_members(swept):
    got, ref = swept
    for g in got:
        _close(g["losses"], ref["losses"])


@pytest.mark.parametrize("b", range(4))
def test_each_member_matches_the_references(swept, b):
    got, ref = swept
    for g in got:
        params, opt = _member_of(ref, b, g["replica"])
        mine = g["members"][b]
        for x, y in zip(mine["params"], params, strict=True):
            _close(x.numpy(), y.numpy())
        for x, y in zip(mine["opt"], opt, strict=True):
            _close(x.numpy(), y.numpy())


@pytest.mark.parametrize("b", range(4))
def test_each_member_is_its_standalone_run(swept, b):
    for g in swept[0]:
        assert g["standalone"][b]["equal"]
        assert g["standalone"][b]["losses"] == g["losses"][b].tolist()


def test_int8_local_h_members_are_their_standalone_runs(swept):
    for g in swept[0]:
        assert [m["point"] for m in g["int8"]] == [
            (s, h) for h in H_LOCAL for s in H_SEEDS]
        assert all(m["equal"] and m["losses"] for m in g["int8"])


def test_ranks_are_the_replicas(swept):
    assert sorted(g["replica"] for g in swept[0]) == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# refusals, message for message, on a one-rank mesh
# ---------------------------------------------------------------------------
def _solo():
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device_type="cpu")
    prob = Problem.lm(ModelConfig(**CFG_KW), make_sgd(), batch=2, seq=16)
    return Session.compile(prob, Topology.from_mesh(
        mesh, sync_axes=("data",), periods=(2,)), backend="mesh", mesh=mesh,
        device="cpu")


def _reference_solo():
    from repro.api import Problem as JProblem
    from repro.api import Session as JSession
    from repro.api import Topology as JTopology
    from repro.configs.base import ModelConfig as JConfig
    from repro.launch.mesh import make_host_mesh as jmesh
    from repro.optim import make_sgd as jsgd
    mesh = jmesh()
    return JSession.compile(
        JProblem.lm(JConfig(**CFG_KW), jsgd(), batch=2, seq=16),
        JTopology.from_mesh(mesh, sync_axes=("data",), periods=(2,)),
        backend="mesh", mesh=mesh)


@pytest.mark.parametrize("kw", [
    dict(lams=[0.1]), dict(schedules=[Schedule()]),
    dict(lams=[0.1, 0.2], continuation=True), dict(seeds=[0], resume="x")])
def test_sdca_axes_are_refused_as_the_reference_refuses_them(kw):
    from repro.api import Schedule as JSchedule
    from repro.api import Sweep as JSweep
    jkw = dict(kw)
    if "schedules" in jkw:
        jkw["schedules"] = [JSchedule()]
    msgs = []
    for sess, spec in ((_solo(), Sweep(**kw)),
                       (_reference_solo(), JSweep(**jkw))):
        with pytest.raises(ValueError) as e:
            sess.sweep(spec, steps=1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_an_sdca_sweep_refuses_lrs_as_the_reference_does():
    import jax.numpy as jnp

    from repro.api import Problem as JProblem
    from repro.api import Session as JSession
    from repro.api import Sweep as JSweep
    from repro.api import Topology as JTopology
    X = np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32)
    y = X.sum(1)
    topo = Topology.star(2, 16, rounds=1, local_steps=4)
    msgs = []
    with pytest.raises(ValueError) as e:
        Session.compile(Problem(torch.from_numpy(X), torch.from_numpy(y),
                                lam=0.1), topo, backend="torch",
                        device="cpu").sweep(Sweep(lrs=[0.1]))
    msgs.append(str(e.value))
    with pytest.raises(ValueError) as e:
        JSession.compile(JProblem(jnp.asarray(X), jnp.asarray(y), lam=0.1),
                         JTopology.star(2, 16, rounds=1, local_steps=4)
                         ).sweep(JSweep(lrs=[0.1]))
    msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "LM-training axis" in msgs[0]


def test_sweep_axes_inline_and_a_one_rank_grid():
    """Axes given inline; a one-rank grid (no syncs) gives the (B, T)
    history and members equal to standalone runs."""
    sess = _solo()
    rs = sess.sweep(lrs=[0.01, 0.1], steps=3)
    assert isinstance(rs, LMRunSet) and rs.losses.shape == (2, 3)
    one = sess.run(steps=3, lr=0.1)
    for x, y in zip(tree_leaves(one.state.params),
                    tree_leaves(rs.member_state(1).params), strict=True):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="at least one axis"):
        Sweep()
    assert Sweep(lrs=[1.0, 2.0], seeds=[0, 1, 2]).shape == (2, 3)
    assert Sweep(lrs=[1.0], local_hs=[2]).expand(0.0)[0].to_dict() == {
        "lam": 0.0, "seed": None, "schedule": None, "local_h": 2, "lr": 1.0}
