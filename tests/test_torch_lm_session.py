"""LM TreeSync sessions (api/lm.py, core/engine/lm.py) on the CPU: four
gloo ranks, one per replica of a (pod, data) = (2, 2) mesh, spawned once
for the module, against the JAX package's LMSession on 4 emulated CPU
devices ((pod, data, model) = (2, 2, 1)) in a child process.

Both packages start every case from the same state: the reference's
``init_state(PRNGKey(0))``, carried to each rank by
``api.convert.lm_state_from_reference``.  The tests hold

  * per-step losses and consensus params to the reference within TOL
    (f32 activations: the same arithmetic in two libraries) for plain
    (AdamW), int8-compressed root (SGD with momentum) and
    straggler-masked (SGD) runs; the straggler policy drops a replica at
    the third round's syncs, so the masked means really run;
  * every replica to hold the same params after the final step's root
    sync (torch.equal across ranks);
  * periods=(1, 1) with SGD(momentum=0) to one process's data-parallel
    steps on the global batch (the paper's star special case) within
    STAR_TOL;
  * a checkpointed run killed after step 4 and resumed to be torch.equal
    to the uninterrupted run; the reference's checkpoint resumed by the
    port, and the port's resumed by the reference, within TOL of the
    other package's uninterrupted run;
  * the executor cache's hit and miss counts, and ``strict=True`` raising
    UnexpectedRetraceError on a forced miss.

The rank program is this module's ``_rank_main``; the spawned processes
import this file, so nothing at its top level imports JAX.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.api import (CheckpointPolicy, Problem, Schedule,  # noqa: E402
                             Session, Topology)
from repro_torch.api.convert import (lm_state_from_reference,  # noqa: E402
                                     lm_state_to_reference)
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import treesync as tsy  # noqa: E402
from repro_torch.core.delay import StragglerModel  # noqa: E402
from repro_torch.core.engine import lm as tlm  # noqa: E402
from repro_torch.optim import make_adamw, make_sgd  # noqa: E402
from repro_torch.optim.api import tree_leaves  # noqa: E402
from repro_torch.runtime import ranks  # noqa: E402
from repro_torch.runtime.straggler import StragglerPolicy  # noqa: E402

WORLD = 4
# against the JAX package: the same f32 arithmetic in two libraries
TOL = dict(rtol=1e-4, atol=1e-5)
# AdamW's normalized step (mhat / sqrt(nhat) ~ sign(g) while nhat is
# small) turns a last-ulp gradient difference near zero into up to lr x
# that sign: over 8 steps at lr 1e-2 a few entries differ by ~2e-5
ADAMW_TOL = dict(rtol=1e-4, atol=5e-5)
# the star special case: four replicas' mean gradient against one batch's
# gradient, the sums reassociated (tests/test_treesync.py's tolerance)
STAR_TOL = dict(rtol=1e-5, atol=1e-6)
SPAWN_TIMEOUT = 300.0
ROOT = Path(__file__).resolve().parents[1]
CFG_KW = dict(name="tiny", family="dense", num_layers=2, d_model=32,
              num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64,
              vocab_size=64, q_chunk_size=16, logits_chunk=16, remat=False,
              activation_dtype="float32")
BATCH, SEQ, STEPS = 8, 16, 8
# (optimizer, its arguments, per-level compression top-down, rounds
# of a straggler run) per case
CASES = {
    "plain": ("adamw", dict(lr=1e-2), None),
    "int8": ("sgd", dict(lr=0.05, momentum=0.9), ("int8", "none")),
    "straggler": ("sgd", dict(lr=0.05, momentum=0.0), None),
}
LEVEL_DELAYS = [1e-3, 5e-2]
STRAGGLER = dict(slow_prob=0.3, slow_factor=50.0)
STRAGGLER_SEED = 1
STRAGGLER_ROUNDS = 4


def _opt(mod, name, kw):
    return getattr(mod, f"make_{name}")(**kw)


# ---------------------------------------------------------------------------
# the rank program
# ---------------------------------------------------------------------------
def _session(case, mesh, periods=(2, 2), **kw):
    name, okw, comp = CASES[case]
    from repro_torch import optim
    prob = Problem.lm(ModelConfig(**CFG_KW), _opt(optim, name, okw),
                      batch=BATCH, seq=SEQ, seed=0)
    topo_kw = (dict(level_delays=LEVEL_DELAYS, t_lp=1e-3)
               if case == "straggler" else {})
    topo = Topology.from_mesh(mesh, sync_axes=("data", "pod"),
                              periods=periods, **topo_kw)
    return Session.compile(prob, topo, Schedule(compression=comp),
                           backend="mesh", mesh=mesh, device="cpu", **kw)


def _own(state) -> dict:
    return {"params": [t.clone() for t in tree_leaves(state.params)],
            "opt": [t.clone() for t in tree_leaves(state.opt_state)]}


def _run_case(case, mesh, ref):
    sess = _session(case, mesh)
    start = lm_state_from_reference(ref[f"{case}_init"], sess.replica,
                                    device="cpu")
    kw = dict(steps=STEPS)
    if case == "straggler":
        kw = dict(rounds=STRAGGLER_ROUNDS, straggler=StragglerPolicy(
            model=StragglerModel(**STRAGGLER), seed=STRAGGLER_SEED))
    res = sess.run(warm_start=start, **kw)
    return {"losses": [h["loss"] for h in res.history],
            "participants": [h.get("participants") for h in res.history],
            "consensus": [t.clone() for t in tree_leaves(res.consensus())],
            "own": _own(res.state), "replica": sess.replica}


def _cases(root: Path, ref: dict) -> dict:
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 2, 1),
                            mesh_dim_names=("pod", "data", "model"))
    out = {name: _run_case(name, mesh, ref) for name in CASES}

    # the star special case: every step a full barrier, SGD(momentum=0)
    star = _session("straggler", mesh, periods=(1, 1))
    start = lm_state_from_reference(ref["straggler_init"], star.replica,
                                    device="cpu")
    res = star.run(steps=3, warm_start=start)
    out["star"] = [t.clone() for t in tree_leaves(res.consensus())]

    # kill after step 4, resume: the uninterrupted run bit for bit
    sess = _session("int8", mesh)
    start = lm_state_from_reference(ref["int8_init"], sess.replica,
                                    device="cpu")
    full = sess.run(steps=6, warm_start=start)
    pol = CheckpointPolicy(root / "port_ckpt", every=1)
    sess.run(steps=4, warm_start=start, checkpoint=pol)
    resumed = sess.resume(pol, steps=2)
    out["resume"] = {"full": _own(full.state), "resumed": _own(resumed.state),
                     "steps": [h["step"] for h in resumed.history],
                     "full_losses": [h["loss"] for h in full.history],
                     "resumed_losses": [h["loss"] for h in resumed.history]}

    # the reference's checkpoint (4 of 6 steps), resumed by the port
    sess = _session("plain", mesh)
    got = sess.resume(CheckpointPolicy(root / "ref_ckpt", every=1), steps=2)
    out["ref_resumed"] = {"losses": [h["loss"] for h in got.history],
                          "own": _own(got.state)}
    # a port checkpoint for the reference to resume: 4 of 6 steps
    start = lm_state_from_reference(ref["plain_init"], sess.replica,
                                    device="cpu")
    sess.run(steps=4, warm_start=start,
             checkpoint=CheckpointPolicy(root / "port_for_ref", every=1))
    full = sess.run(steps=6, warm_start=start)
    out["port_full"] = {"losses": [h["loss"] for h in full.history],
                        "own": _own(full.state)}

    # executor cache: a second run of a built variant hits
    tlm.clear_lm_executor_cache()
    s0 = tlm.lm_executor_cache_stats()
    sess.run(steps=1, warm_start=start)
    sess.run(steps=1, warm_start=start)
    sess.run(steps=1, warm_start=start, lr=0.01)
    out["cache"] = [s0, tlm.lm_executor_cache_stats(), sess.cache_stats()]

    # strict mode: a forced miss on a built variant raises
    strict = _session("plain", mesh, strict=True)
    strict.run(steps=1, warm_start=start)
    tlm.clear_lm_executor_cache()
    from repro_torch.analysis import UnexpectedRetraceError
    try:
        strict.run(steps=1, warm_start=start)
        out["strict"] = "no error"
    except UnexpectedRetraceError as e:
        out["strict"] = [type(e).__name__, e.misses[0]["backend"]]

    # the deprecated static-periods shim
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ts = tsy.TreeSyncConfig(sync_axes=("data", "pod"), periods=(2, 2))
        step = tsy.make_treesync_step(ModelConfig(**CFG_KW),
                                      make_adamw(lr=1e-2), ts, mesh)
    state = lm_state_from_reference(ref["plain_init"], sess.replica,
                                    device="cpu")
    from repro_torch.data.lm import lm_batch
    for i in range(STEPS):
        b = lm_batch(ModelConfig(**CFG_KW), BATCH, SEQ, i, seed=0,
                     device="cpu")
        state, _ = step(state, tsy.split_batch(b, 4, sess.replica))
    out["shim"] = {"own": _own(state),
                   "warned": [w.category.__name__ for w in caught]}
    out["replica_count"] = tsy.replica_count(ts, mesh)
    return out


def _rank_main(rank, world, root):
    torch.set_num_threads(1)
    root = Path(root)
    with open(root / "reference.pkl", "rb") as f:
        ref = pickle.load(f)
    ranks.init(rank, world, f"file://{root / 'pg'}")
    out = _cases(root, ref)
    torch.save(out, root / f"rank{rank}.pt")
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX package's LMSession, in children with 4 emulated devices
# ---------------------------------------------------------------------------
def _np_state(state) -> dict:
    import jax
    return {"params": jax.tree.map(np.asarray, state.params),
            "opt_state": jax.tree.map(np.asarray, state.opt_state),
            "step": np.asarray(state.step),
            "residual": (None if state.residual is None
                         else jax.tree.map(np.asarray, state.residual))}


def _reference_session(case, periods=(2, 2)):
    import jax

    from repro import optim as joptim
    from repro.api import Problem as JProblem
    from repro.api import Schedule as JSchedule
    from repro.api import Session as JSession
    from repro.api import Topology as JTopology
    from repro.configs.base import ModelConfig as JConfig
    mesh = jax.make_mesh((2, 2, 1), ("pod", "data", "model"),
                         devices=jax.devices()[:4])
    name, okw, comp = CASES[case]
    prob = JProblem.lm(JConfig(**CFG_KW), _opt(joptim, name, okw),
                       batch=BATCH, seq=SEQ, seed=0)
    topo_kw = (dict(level_delays=LEVEL_DELAYS, t_lp=1e-3)
               if case == "straggler" else {})
    topo = JTopology.from_mesh(mesh, sync_axes=("data", "pod"),
                               periods=periods, **topo_kw)
    return JSession.compile(prob, topo, JSchedule(compression=comp),
                            backend="mesh", mesh=mesh)


def _reference_program(root):
    import jax

    from repro.api import CheckpointPolicy as JPolicy
    from repro.core.delay import StragglerModel as JModel
    from repro.runtime.straggler import StragglerPolicy as JPolicyS
    root = Path(root)
    out = {}
    for case in CASES:
        sess = _reference_session(case)
        init = sess.init_state(jax.random.PRNGKey(0))
        out[f"{case}_init"] = _np_state(init)
        kw = dict(steps=STEPS)
        if case == "straggler":
            kw = dict(rounds=STRAGGLER_ROUNDS, straggler=JPolicyS(
                model=JModel(**STRAGGLER), seed=STRAGGLER_SEED))
        res = sess.run(warm_start=init, **kw)
        out[f"{case}_losses"] = [h["loss"] for h in res.history]
        out[f"{case}_participants"] = [h.get("participants")
                                       for h in res.history]
        out[f"{case}_consensus"] = jax.tree.map(np.asarray,
                                                res.consensus())
        out[f"{case}_final"] = _np_state(res.state)
    sess = _reference_session("plain")
    init = sess.init_state(jax.random.PRNGKey(0))
    full = sess.run(steps=6, warm_start=init)
    out["plain_full6"] = {"losses": [h["loss"] for h in full.history],
                          "state": _np_state(full.state)}
    sess.run(steps=4, warm_start=init,
             checkpoint=JPolicy(directory=str(root / "ref_ckpt"), every=1))
    with open(root / "reference.pkl", "wb") as f:
        pickle.dump(out, f)


def _reference_resume(root):
    """The port's checkpoint of the plain case, resumed by the reference."""
    from repro.api import CheckpointPolicy as JPolicy
    root = Path(root)
    res = _reference_session("plain").resume(
        JPolicy(directory=str(root / "port_for_ref"), every=1), steps=2)
    with open(root / "reference_resume.pkl", "wb") as f:
        pickle.dump({"losses": [h["loss"] for h in res.history],
                     "state": _np_state(res.state)}, f)


def _run_reference(fn: str, root: Path) -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            f"import test_torch_lm_session as t; t.{fn}(sys.argv[2])")
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
def lm_run(tmp_path_factory):
    """(rank results, the reference's results, the reference's resume of
    the port's checkpoint)."""
    root = tmp_path_factory.mktemp("lm_session")
    _run_reference("_reference_program", root)
    ranks.spawn(_rank_main, WORLD, args=(WORLD, str(root)),
                timeout=SPAWN_TIMEOUT)
    _run_reference("_reference_resume", root)
    got = [torch.load(root / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    with open(root / "reference.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(root / "reference_resume.pkl", "rb") as f:
        ref_resume = pickle.load(f)
    return got, ref, ref_resume, root


def _tol(case):
    return ADAMW_TOL if CASES[case][0] == "adamw" else TOL


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **tol)


def _leaves(tree):
    from repro_torch.optim.api import tree_leaves as leaves
    return leaves(tree)


def _own_of(state_np, replica) -> dict:
    st = lm_state_from_reference(state_np, replica, device="cpu")
    return {"params": tree_leaves(st.params), "opt": tree_leaves(st.opt_state)}


# ---------------------------------------------------------------------------
# runs against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(CASES))
def test_losses_match_the_reference(lm_run, case):
    got, ref = lm_run[0], lm_run[1]
    assert len(got[0][case]["losses"]) == len(ref[f"{case}_losses"])
    _close(got[0][case]["losses"], ref[f"{case}_losses"])
    assert np.isfinite(got[0][case]["losses"]).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_consensus_params_match_the_reference(lm_run, case):
    got, ref = lm_run[0], lm_run[1]
    for a, b in zip(got[0][case]["consensus"],
                    _leaves(ref[f"{case}_consensus"]), strict=True):
        _close(a.numpy(), b, _tol(case))


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_replica_matches_the_reference(lm_run, case):
    got, ref = lm_run[0], lm_run[1]
    for r in range(WORLD):
        mine = got[r][case]
        want = _own_of(ref[f"{case}_final"], mine["replica"])
        for a, b in zip(mine["own"]["params"], want["params"], strict=True):
            _close(a.numpy(), b.numpy(), _tol(case))
        for a, b in zip(mine["own"]["opt"], want["opt"], strict=True):
            _close(a.numpy(), b.numpy(), _tol(case))


@pytest.mark.parametrize("case", sorted(CASES))
def test_replicas_agree_after_the_root_sync(lm_run, case):
    """The last step is a root sync: every rank holds the same params."""
    got = lm_run[0]
    for r in range(1, WORLD):
        for a, b in zip(got[0][case]["own"]["params"],
                        got[r][case]["own"]["params"], strict=True):
            assert torch.equal(a, b)


def test_ranks_are_the_replicas_in_reference_order(lm_run):
    assert sorted(g["plain"]["replica"] for g in lm_run[0]) == [0, 1, 2, 3]


def test_the_straggler_run_drops_a_replica(lm_run):
    got, ref = lm_run[0], lm_run[1]
    parts = got[0]["straggler"]["participants"]
    assert parts == ref["straggler_participants"]
    assert min(parts) < WORLD and parts[-1] == WORLD


def test_the_star_case_is_data_parallel_sgd(lm_run):
    """periods=(1, 1) + SGD(momentum=0) == one process taking the same
    steps on the global batch (the paper's star network)."""
    from repro_torch.data.lm import lm_batch
    from repro_torch.launch.steps import make_train_step
    got, ref = lm_run[0], lm_run[1]
    cfg = ModelConfig(**CFG_KW)
    st = lm_state_from_reference(ref["straggler_init"], 0, device="cpu")
    params, opt_state = st.params, st.opt_state
    step = make_train_step(cfg, make_sgd(lr=0.05, momentum=0.0))
    for i in range(3):
        params, opt_state, _ = step(params, opt_state,
                                    lm_batch(cfg, BATCH, SEQ, i, seed=0,
                                             device="cpu"))
    for a, b in zip(got[0]["star"], tree_leaves(params), strict=True):
        _close(a.numpy(), b.numpy(), STAR_TOL)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_resume_equals_the_uninterrupted_run(lm_run):
    for g in lm_run[0]:
        r = g["resume"]
        assert r["steps"] == list(range(1, 7))
        assert r["resumed_losses"] == r["full_losses"]
        for a, b in zip(r["full"]["params"] + r["full"]["opt"],
                        r["resumed"]["params"] + r["resumed"]["opt"],
                        strict=True):
            assert torch.equal(a, b)


def test_the_port_resumes_a_reference_checkpoint(lm_run):
    got, ref = lm_run[0], lm_run[1]
    full = ref["plain_full6"]
    _close(got[0]["ref_resumed"]["losses"], full["losses"])
    for g in got:
        want = _own_of(full["state"], g["plain"]["replica"])
        for a, b in zip(g["ref_resumed"]["own"]["params"], want["params"],
                        strict=True):
            _close(a.numpy(), b.numpy())


def test_the_reference_resumes_a_port_checkpoint(lm_run):
    got, ref_resume = lm_run[0], lm_run[2]
    _close(ref_resume["losses"], got[0]["port_full"]["losses"])
    for g in got:
        want = _own_of(ref_resume["state"], g["plain"]["replica"])
        for a, b in zip(g["port_full"]["own"]["params"], want["params"],
                        strict=True):
            _close(a.numpy(), b.numpy())


def test_the_port_writes_the_reference_file_format(lm_run):
    """One payload per snapshot, the reference's entry names and (R, ...)
    shapes: the step under "None", params and optimizer state under
    "None/<path>"; an int8 run adds its residuals under "residual/"."""
    root = lm_run[3]

    def entries(d):
        from repro_torch.runtime.checkpoint import CheckpointManager
        mgr = CheckpointManager(directory=str(root / d))
        with np.load(mgr._path(mgr.latest_step())) as z:
            return {k: z[k].shape for k in z.files}
    port, ref = entries("port_for_ref"), entries("ref_ckpt")
    assert port == ref
    assert port["None"] == () and port["None/embed"] == (4, 64, 32)
    int8 = entries("port_ckpt")
    res = {k for k in int8 if k.startswith("residual/")}
    assert {k[len("residual/"):] for k in res} == {
        k[len("None/"):] for k in int8
        if k.startswith("None/") and not k.startswith(("None/mom", "None/step"))}


# ---------------------------------------------------------------------------
# executor cache, strict mode, the shim
# ---------------------------------------------------------------------------
def test_executor_cache_counts(lm_run):
    s0, s1, sess_stats = lm_run[0][0]["cache"]
    assert s0 == {"hits": 0, "misses": 0, "size": 0}
    # the plain variant built once and hit once; the lr variant built once
    assert s1 == {"hits": 1, "misses": 2, "size": 2}
    assert sess_stats == s1


def test_strict_raises_on_a_forced_miss(lm_run):
    assert lm_run[0][0]["strict"] == ["UnexpectedRetraceError", "lm"]


def test_the_deprecated_shim_is_the_session(lm_run):
    got, ref = lm_run[0], lm_run[1]
    assert got[0]["replica_count"] == 4
    assert "DeprecationWarning" in got[0]["shim"]["warned"]
    for g in got:
        for a, b in zip(g["shim"]["own"]["params"], g["plain"]["own"]["params"],
                        strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kw,msg", [
    (dict(sync_axes=("data",), periods=(0,)), "positive"),
    (dict(sync_axes=("data",), periods=(-2,)), "positive"),
    (dict(sync_axes=("data", "data"), periods=(2, 2)), "duplicate"),
    (dict(sync_axes=("data",), periods=(2, 2)), "periods"),
    (dict(sync_axes=("data",), periods=(2,), compression="zstd"),
     "compression"),
])
def test_treesync_config_validation(kw, msg):
    with pytest.raises(ValueError, match=msg):
        tsy.TreeSyncConfig(**kw)


def test_treesync_config_messages_are_the_reference():
    from repro.core import treesync as jtsy
    for kw in (dict(periods=(0,)), dict(sync_axes=("data", "data")),
               dict(sync_axes=("data",), periods=(2, 2)),
               dict(compression="zstd")):
        msgs = []
        for mod in (tsy, jtsy):
            with pytest.raises(ValueError) as e:
                mod.TreeSyncConfig(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_lm_sessions_compile_on_the_mesh_backend_only():
    from repro_torch.launch.mesh import make_host_mesh
    prob = Problem.lm(ModelConfig(**CFG_KW), make_sgd(), batch=2, seq=16)
    with pytest.raises(ValueError, match="backend='mesh'"):
        Session.compile(prob, None, backend="torch", device="cpu")
    sess = Session.compile(prob, None, backend="mesh", device="cpu",
                           mesh=make_host_mesh(device_type="cpu"))
    assert sess.n_replicas == 1 and sess.writer
    # the LM sweep runs on the mesh backend's one-rank mesh too
    rs = sess.sweep(lrs=[0.1], steps=1)
    assert rs.losses.shape == (1, 1) and np.isfinite(rs.losses).all()


def test_a_codec_below_the_root_is_refused():
    from repro_torch.api.lm import LMSession
    mesh = type("M", (), {"mesh_dim_names": ("pod", "data", "model"),
                          "shape": (2, 2, 1)})()
    prob = Problem.lm(ModelConfig(**CFG_KW), make_sgd(), batch=4, seq=16)
    topo = Topology.from_mesh(mesh, sync_axes=("data", "pod"),
                              periods=(2, 2))
    with pytest.raises(ValueError, match="root"):
        LMSession.compile(prob, topo, Schedule(compression=("none", "int8")),
                          mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="do not match the mesh"):
        LMSession.compile(prob, Topology.star(4, 1), mesh=mesh, device="cpu")


def test_state_round_trip_through_the_reference_layout():
    """lm_state_to_reference of per-replica states is the stacked state
    lm_state_from_reference takes rows of."""
    from repro_torch.core.engine.lm import init_lm_state
    from repro_torch.core.prng import PRNGKey
    cfg = dataclasses.replace(ModelConfig(**CFG_KW), num_layers=3)
    states = [init_lm_state(cfg, make_adamw(), PRNGKey(s),
                            compression="int8", device="cpu")
              for s in range(2)]
    stacked = lm_state_to_reference(states)
    for r, st in enumerate(states):
        back = lm_state_from_reference(stacked, r, device="cpu")
        for a, b in zip(tree_leaves(st.params) + tree_leaves(st.opt_state)
                        + tree_leaves(st.residual),
                        tree_leaves(back.params) + tree_leaves(back.opt_state)
                        + tree_leaves(back.residual), strict=True):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# one process: a one-rank mesh (no process group), as the JAX suite runs
# ---------------------------------------------------------------------------
def _solo_session(periods=(2,), schedule=None, **topo_kw):
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device_type="cpu")
    prob = Problem.lm(ModelConfig(**CFG_KW), make_sgd(lr=0.05, momentum=0.0),
                      batch=8, seq=16, seed=0)
    topo = Topology.from_mesh(mesh, sync_axes=("data",), periods=periods,
                              **topo_kw)
    return Session.compile(prob, topo, schedule, backend="mesh", mesh=mesh,
                           device="cpu")


def test_one_rank_matches_the_reference_session():
    """make_host_mesh() without a process group is one replica, as the
    reference's host mesh on one device: the same losses and params from
    the same state."""
    import jax
    from repro.api import Problem as JProblem
    from repro.api import Session as JSession
    from repro.api import Topology as JTopology
    from repro.configs.base import ModelConfig as JConfig
    from repro.launch.mesh import make_host_mesh as jmesh
    from repro.optim import make_sgd as jsgd
    mesh = jmesh()
    jsess = JSession.compile(
        JProblem.lm(JConfig(**CFG_KW), jsgd(lr=0.05, momentum=0.0), batch=8,
                    seq=16, seed=0),
        JTopology.from_mesh(mesh, sync_axes=("data",), periods=(2,)),
        backend="mesh", mesh=mesh)
    init = jsess.init_state(jax.random.PRNGKey(0))
    want = jsess.run(steps=4, warm_start=init)
    sess = _solo_session()
    assert sess.n_replicas == 1 and sess.replica == 0
    got = sess.run(steps=4, warm_start=lm_state_from_reference(
        _np_state(init), 0, device="cpu"))
    _close([h["loss"] for h in got.history],
           [h["loss"] for h in want.history])
    for a, b in zip(tree_leaves(got.consensus()),
                    _leaves(jax.tree.map(np.asarray, want.consensus())),
                    strict=True):
        _close(a.numpy(), b)


def test_straggler_adaptive_history():
    """An adaptive straggler policy: per-round clocks, participants and
    the executed local H in the history, the replanned H fed through the
    periods operand without a new executor."""
    from repro_torch.runtime.straggler import AdaptiveSchedule
    sess = _solo_session(level_delays=[0.5], t_lp=1e-3)
    pol = StragglerPolicy(seed=0, adaptive=AdaptiveSchedule())
    out = sess.run(rounds=4, straggler=pol)
    last = out.history[-1]
    for k in ("time", "time_sync", "participants", "h"):
        assert k in last, sorted(last)
    assert np.isfinite(out.final_loss)
    assert sess.cache_stats()["size"] >= 1


def test_auto_schedule_plans_lm_periods():
    from repro_torch.api import DelayModel
    sess = _solo_session(
        schedule=Schedule(rounds="auto", compression="auto",
                          delay=DelayModel(C=1.0, delta=0.05, t_total=2.0)),
        level_delays=[0.5], t_lp=1e-3)
    assert all(p >= 1 for p in sess.periods)
    assert np.isfinite(sess.run(steps=2).final_loss)


def test_the_train_cli_trains_and_resumes(tmp_path, capsys):
    from repro_torch.configs import recurrentgemma_2b
    from repro_torch.launch import train
    from repro_torch.launch.mesh import data_axes, make_host_mesh
    assert data_axes(make_host_mesh(device_type="cpu")) == ("data",)
    cfg = recurrentgemma_2b.SMOKE
    kw = dict(batch=2, seq=32, periods=(2,), device="cpu",
              ckpt_dir=str(tmp_path), ckpt_every=2, log_every=1)
    first = train.train(cfg, steps=2, **kw)
    assert [e["step"] for e in first["history"]] == [1, 2]
    more = train.train(cfg, steps=4, **kw)
    assert [e["step"] for e in more["history"]] == [3, 4]
    assert "resumed from step 2" in capsys.readouterr().out
    sync = train.train(cfg, steps=2, batch=2, seq=32, sync=True,
                       device="cpu")
    assert np.isfinite(sync["final_loss"])


def test_trace_guard_pieces():
    """check_finite names the first non-finite leaf; as_trace_guard
    normalizes strict=; no_retrace reports the missed key's diff against
    the nearest cached one."""
    from repro_torch.analysis import (NonFiniteError, TraceGuard,
                                      UnexpectedRetraceError, as_trace_guard,
                                      check_finite, no_retrace)
    state = tlm.TreeSyncState(params={"a": torch.ones(3),
                                      "b": torch.tensor([1.0, float("nan")])},
                              opt_state={"step": torch.zeros((),
                                                             dtype=torch.int32)},
                              step=0)
    with pytest.raises(NonFiniteError) as e:
        check_finite(state, "state")
    assert e.value.where == "state.params['b']"
    assert as_trace_guard(False) is None
    assert as_trace_guard(True) == TraceGuard()
    with pytest.raises(TypeError):
        as_trace_guard("yes")
    cfg = ModelConfig(**CFG_KW)
    opt = make_sgd()
    tlm.get_lm_executor(cfg, opt, level_sizes=())
    with no_retrace():
        tlm.get_lm_executor(cfg, opt, level_sizes=())
    with pytest.raises(UnexpectedRetraceError) as e:
        with no_retrace():
            tlm.get_lm_executor(cfg, opt, level_sizes=(), with_lr=True)
    assert e.value.misses[-1]["diff"] == {"with_lr": (True, False)}
