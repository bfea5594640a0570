"""TreeSync LM sessions over tensor-parallel replicas (api/lm.py,
core/engine/lm.py::ReplicaTP) on the CPU: four gloo ranks as a ("data",
"model") = (2, 2) mesh -- two replicas of two model ranks each --
spawned once for the module, against the JAX package's LMSession on the
same (2, 2) mesh of 4 emulated CPU devices in a child process (whose
``model`` axis changes nothing in its numbers: it never places its state
by ``replica_specs``), and against the port's own ``model`` = 1 run on a
(2, 1) mesh of two gloo ranks, spawned once after the four.

Both packages start every case from the same state: the reference's
``init_state(PRNGKey(0))``, cut to each rank's shards by
``api.convert.lm_state_from_reference(..., cfg=, mesh=)``.  The model is
tests/test_torch_lm_session.py's at float32 activations; on ``model`` = 2
its q projection's shards are runs of 16 along the flattened leaf, not
whole int8 blocks, so the int8 root quantizes that leaf's delta gathered
whole, and the embedding's shards are whole blocks, quantized on their
own.  The tests hold

  * per-step losses and consensus params to the reference within TOL
    (ADAMW_TOL for AdamW) for plain (AdamW), int8-compressed root (SGD
    with momentum) and straggler-masked (SGD) runs; the straggler policy
    drops a replica, so the masked means really run;
  * the ranks that share a ``model`` coordinate to hold torch.equal
    shards after the last step's sync, and every rank the same whole
    consensus;
  * the ``model`` = 2 runs, and a top-k root (which selects over each
    replica's whole leaf), to the port's ``model`` = 1 runs within twice
    the tolerance each holds against the reference;
  * a checkpoint written on (2, 2) resumed on (2, 1), and the reference's
    checkpoint resumed on (2, 2), within TOL of the other run; the (2, 2)
    file has the reference's entries and shapes;
  * ``LMSession.sweep`` members torch.equal to their standalone runs, the
    deprecated ``make_treesync_step`` shim equal to the session, and
    ``treesync.init_state`` the cut of the whole state.

The rank programs are this module's ``_rank_main`` and ``_pair_main``;
the spawned processes import this file, so nothing at its top level
imports JAX.
"""
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
                             Session, Sweep, Topology)
from repro_torch.api.convert import lm_state_from_reference  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import treesync as tsy  # noqa: E402
from repro_torch.core.delay import StragglerModel  # noqa: E402
from repro_torch.core.prng import PRNGKey  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.optim import make_adamw  # noqa: E402
from repro_torch.optim.api import tree_leaves  # noqa: E402
from repro_torch.runtime import ranks  # noqa: E402
from repro_torch.runtime.straggler import StragglerPolicy  # noqa: E402

WORLD = 4
# against the JAX package and against the port's model = 1 run: float32
# arithmetic whose sums the model split reorders (the row-parallel
# partial sums, the vocab-parallel logsumexp), as
# tests/test_torch_lm_session.py's tolerances for two libraries
TOL = dict(rtol=1e-4, atol=1e-5)
ADAMW_TOL = dict(rtol=1e-4, atol=5e-5)
# the model = 2 runs against the port's model = 1 runs: each within its
# tolerance of the reference (a top-k root, which the reference compresses
# otherwise, within TOL's of the same arithmetic), so twice it -- AdamW's
# normalized step moves a near-zero gradient's entry by up to lr where its
# sign flips, in either run (measured: one entry of 4096 off by 1.2e-4)
def twice(tol):
    return {k: 2 * v for k, v in tol.items()}

SPAWN_TIMEOUT = 300.0
ROOT = Path(__file__).resolve().parents[1]
CFG_KW = dict(name="tiny", family="dense", num_layers=2, d_model=32,
              num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64,
              vocab_size=64, q_chunk_size=16, logits_chunk=16, remat=False,
              activation_dtype="float32")
BATCH, SEQ, STEPS, PERIODS = 8, 16, 8, (2,)
# (optimizer, its arguments, root compression) per case
CASES = {
    "plain": ("adamw", dict(lr=1e-2), None),
    "int8": ("sgd", dict(lr=0.05, momentum=0.9), ("int8",)),
    "straggler": ("sgd", dict(lr=0.05, momentum=0.0), None),
    "topk": ("sgd", dict(lr=0.05, momentum=0.9), ("topk_0.25",)),
}
REF_CASES = ("plain", "int8", "straggler")     # the reference runs these
LEVEL_DELAYS = [5e-2]
# a replica drops out in the fifth round
STRAGGLER = dict(slow_prob=0.3, slow_factor=50.0)
STRAGGLER_SEED = 3
STRAGGLER_ROUNDS = 6
SWEEP = dict(lrs=[1e-2, 3e-3], seeds=[0, 1])
SWEEP_STEPS = 2


def _cfg():
    return ModelConfig(**CFG_KW)


def _opt(mod, name, kw):
    return getattr(mod, f"make_{name}")(**kw)


# ---------------------------------------------------------------------------
# the rank programs
# ---------------------------------------------------------------------------
def _mesh(model: int):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", (2, model),
                            mesh_dim_names=("data", "model"))


def _session(case, mesh, **kw):
    name, okw, comp = CASES[case]
    from repro_torch import optim
    prob = Problem.lm(_cfg(), _opt(optim, name, okw), batch=BATCH, seq=SEQ,
                      seed=0)
    topo_kw = (dict(level_delays=LEVEL_DELAYS, t_lp=1e-3)
               if case == "straggler" else {})
    topo = Topology.from_mesh(mesh, sync_axes=("data",), periods=PERIODS,
                              **topo_kw)
    return Session.compile(prob, topo, Schedule(compression=comp),
                           backend="mesh", mesh=mesh, device="cpu", **kw)


def _start(ref, case, sess, mesh):
    return lm_state_from_reference(ref[f"{case}_init"], sess.replica,
                                   device="cpu", cfg=_cfg(), mesh=mesh)


def _own(state) -> dict:
    return {"params": [t.clone() for t in tree_leaves(state.params)],
            "opt": [t.clone() for t in tree_leaves(state.opt_state)]}


def _run_case(case, mesh, ref):
    sess = _session(case, mesh)
    kw = dict(steps=STEPS)
    if case == "straggler":
        kw = dict(rounds=STRAGGLER_ROUNDS, straggler=StragglerPolicy(
            model=StragglerModel(**STRAGGLER), seed=STRAGGLER_SEED))
    res = sess.run(warm_start=_start(ref, case, sess, mesh), **kw)
    return {"losses": [h["loss"] for h in res.history],
            "participants": [h.get("participants") for h in res.history],
            "consensus": [t.clone() for t in tree_leaves(res.consensus())],
            "own": _own(res.state), "replica": sess.replica,
            "model_rank": (sess.tp.model_rank if sess.tp is not None
                           else 0)}


def _rank_main(rank, world, root):
    """(data, model) = (2, 2): the cases, checkpoints, the sweep, the
    shim and init_state."""
    torch.set_num_threads(1)
    root = Path(root)
    with open(root / "reference.pkl", "rb") as f:
        ref = pickle.load(f)
    ranks.init(rank, world, f"file://{root / 'pg4'}")
    mesh = _mesh(2)
    out = {name: _run_case(name, mesh, ref) for name in CASES}

    # a (2, 2) checkpoint of the plain case at step 4 (for the (2, 1)
    # ranks to resume), and the uninterrupted 6 steps
    sess = _session("plain", mesh)
    start = _start(ref, "plain", sess, mesh)
    sess.run(steps=4, warm_start=start,
             checkpoint=CheckpointPolicy(root / "ckpt22", every=1))
    full = sess.run(steps=6, warm_start=start)
    out["full6"] = {"losses": [h["loss"] for h in full.history],
                    "consensus": [t.clone() for t in
                                  tree_leaves(full.consensus())]}
    # the reference's checkpoint (4 of 6 steps), resumed here
    got = sess.resume(CheckpointPolicy(root / "ref_ckpt", every=1), steps=2)
    out["ref_resumed"] = {"losses": [h["loss"] for h in got.history],
                          "consensus": [t.clone() for t in
                                        tree_leaves(got.consensus())]}

    # the sweep: members torch.equal to their standalone runs
    sw = _session("plain", mesh)
    rs = sw.sweep(Sweep(**SWEEP), steps=SWEEP_STEPS)
    alone = [sw.run(steps=SWEEP_STEPS, key=PRNGKey(pt.seed), lr=pt.lr)
             for pt in rs.points]
    out["sweep"] = all(
        all(torch.equal(a, b) for a, b in
            zip(tree_leaves(st.params) + tree_leaves(st.opt_state),
                tree_leaves(one.state.params)
                + tree_leaves(one.state.opt_state), strict=True))
        and list(rs.losses[i]) == [h["loss"] for h in one.history]
        for i, (st, one) in enumerate(zip(rs.states, alone, strict=True)))

    # the deprecated shim on a model axis: the session's plain run
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ts = tsy.TreeSyncConfig(sync_axes=("data",), periods=PERIODS)
        step = tsy.make_treesync_step(_cfg(), make_adamw(lr=1e-2), ts, mesh)
    state = _start(ref, "plain", sess, mesh)
    from repro_torch.data.lm import lm_batch
    for i in range(STEPS):
        b = lm_batch(_cfg(), BATCH, SEQ, i, seed=0, device="cpu")
        state, _ = step(state, tsy.split_batch(b, 2, sess.replica))
    out["shim"] = _own(state)
    # treesync.init_state: this rank's cut of the whole state
    mine = tsy.init_state(_cfg(), make_adamw(), 0, mesh, ts, device="cpu")
    whole = tsy.init_state(_cfg(), make_adamw(), 0, _solo_mesh(), ts,
                           device="cpu")
    specs = sh.param_specs(_cfg(), _shape(), mesh, tsy.tp_rules())
    out["init_cut"] = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(mine.params),
        tree_leaves(sh.shard_tree(whole.params, specs, mesh)), strict=True))
    out["init_shapes"] = [tuple(t.shape) for t in tree_leaves(mine.params)]
    torch.save(out, root / f"rank{rank}.pt")
    dist.destroy_process_group()


def _solo_mesh():
    from repro_torch.launch.mesh import HostMesh
    return HostMesh("cpu")


def _shape():
    from repro_torch.launch.steps import params_shape
    return params_shape(_cfg())


def _pair_main(rank, world, root):
    """(data, model) = (2, 1): the port's model = 1 runs, and the (2, 2)
    checkpoint resumed."""
    torch.set_num_threads(1)
    root = Path(root)
    with open(root / "reference.pkl", "rb") as f:
        ref = pickle.load(f)
    ranks.init(rank, world, f"file://{root / 'pg2'}")
    mesh = _mesh(1)
    out = {name: _run_case(name, mesh, ref)
           for name in ("plain", "int8", "topk")}
    sess = _session("plain", mesh)
    got = sess.resume(CheckpointPolicy(root / "ckpt22", every=1), steps=2)
    out["resumed22"] = {"losses": [h["loss"] for h in got.history],
                        "consensus": [t.clone() for t in
                                      tree_leaves(got.consensus())]}
    torch.save(out, root / f"pair{rank}.pt")
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX package's LMSession on (2, 2), in a child with 4 emulated devices
# ---------------------------------------------------------------------------
def _np_state(state) -> dict:
    import jax
    return {"params": jax.tree.map(np.asarray, state.params),
            "opt_state": jax.tree.map(np.asarray, state.opt_state),
            "step": np.asarray(state.step),
            "residual": (None if state.residual is None
                         else jax.tree.map(np.asarray, state.residual))}


def _reference_session(case):
    import jax

    from repro import optim as joptim
    from repro.api import Problem as JProblem
    from repro.api import Schedule as JSchedule
    from repro.api import Session as JSession
    from repro.api import Topology as JTopology
    from repro.configs.base import ModelConfig as JConfig
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         devices=jax.devices()[:4])
    name, okw, comp = CASES[case]
    prob = JProblem.lm(JConfig(**CFG_KW), _opt(joptim, name, okw),
                       batch=BATCH, seq=SEQ, seed=0)
    topo_kw = (dict(level_delays=LEVEL_DELAYS, t_lp=1e-3)
               if case == "straggler" else {})
    topo = JTopology.from_mesh(mesh, sync_axes=("data",), periods=PERIODS,
                               **topo_kw)
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
        sess = _reference_session(case if case in REF_CASES else "int8")
        init = sess.init_state(jax.random.PRNGKey(0))
        out[f"{case}_init"] = _np_state(init)
        if case not in REF_CASES:
            continue
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
    sess = _reference_session("plain")
    init = sess.init_state(jax.random.PRNGKey(0))
    full = sess.run(steps=6, warm_start=init)
    out["plain_full6"] = {"losses": [h["loss"] for h in full.history],
                          "consensus": jax.tree.map(np.asarray,
                                                    full.consensus())}
    sess.run(steps=4, warm_start=init,
             checkpoint=JPolicy(directory=str(root / "ref_ckpt"), every=1))
    with open(root / "reference.pkl", "wb") as f:
        pickle.dump(out, f)


def _run_reference(root: Path) -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_lm_tp as t; t._reference_program(sys.argv[2])")
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
def lm_tp_run(tmp_path_factory):
    """(the four (2, 2) ranks' results, the two (2, 1) ranks', the
    reference's, the directory)."""
    root = tmp_path_factory.mktemp("lm_tp")
    _run_reference(root)
    ranks.spawn(_rank_main, WORLD, args=(WORLD, str(root)),
                timeout=SPAWN_TIMEOUT)
    ranks.spawn(_pair_main, 2, args=(2, str(root)), timeout=SPAWN_TIMEOUT)
    got = [torch.load(root / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    pair = [torch.load(root / f"pair{r}.pt", weights_only=False)
            for r in range(2)]
    with open(root / "reference.pkl", "rb") as f:
        ref = pickle.load(f)
    return got, pair, ref, root


def _tol(case):
    return ADAMW_TOL if CASES[case][0] == "adamw" else TOL


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **tol)


def _consensus_close(got, want, tol):
    assert len(got) == len(want)
    for a, b in zip(got, want, strict=True):
        assert tuple(a.shape) == tuple(np.shape(b))
        _close(a.numpy(), np.asarray(b), tol)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", REF_CASES)
def test_losses_match_the_reference(lm_tp_run, case):
    got, _, ref, _ = lm_tp_run
    for g in got:
        assert len(g[case]["losses"]) == len(ref[f"{case}_losses"])
        _close(g[case]["losses"], ref[f"{case}_losses"])


@pytest.mark.parametrize("case", REF_CASES)
def test_consensus_params_match_the_reference(lm_tp_run, case):
    got, _, ref, _ = lm_tp_run
    want = tree_leaves(ref[f"{case}_consensus"])
    for g in got:
        _consensus_close(g[case]["consensus"], want, _tol(case))


def test_the_straggler_run_drops_a_replica(lm_tp_run):
    got, _, ref, _ = lm_tp_run
    parts = got[0]["straggler"]["participants"]
    assert parts == ref["straggler_participants"]
    assert min(parts) < 2 and parts[-1] == 2
    assert all(g["straggler"]["participants"] == parts for g in got)


def test_replicas_and_model_ranks(lm_tp_run):
    """Ranks (0, 1) are replica 0's model ranks 0 and 1, (2, 3) replica
    1's; the shards of a model coordinate agree after the last step's
    sync, and every rank gathers the same whole consensus."""
    got = lm_tp_run[0]
    assert [(g["plain"]["replica"], g["plain"]["model_rank"])
            for g in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for case in CASES:
        for a, b in ((0, 2), (1, 3)):
            for x, y in zip(got[a][case]["own"]["params"],
                            got[b][case]["own"]["params"], strict=True):
                assert torch.equal(x, y), case
        for g in got[1:]:
            for x, y in zip(got[0][case]["consensus"], g[case]["consensus"],
                            strict=True):
                assert torch.equal(x, y), case
    # the two model ranks hold different halves of a split leaf
    assert not torch.equal(got[0]["plain"]["own"]["params"][0],
                           got[1]["plain"]["own"]["params"][0])


# ---------------------------------------------------------------------------
# against the port's model = 1 runs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["plain", "int8", "topk"])
def test_model_2_matches_model_1(lm_tp_run, case):
    got, pair, _, _ = lm_tp_run
    tol = twice(_tol(case))
    _close(got[0][case]["losses"], pair[0][case]["losses"], tol)
    _consensus_close(got[0][case]["consensus"], pair[0][case]["consensus"],
                     tol)


def test_the_int8_root_gathers_misaligned_shards():
    """On model = 2 the q projection's shards (32 rows of 16 columns) are
    not runs of whole int8 blocks, so the root gathers that leaf's delta;
    the embedding's (32 of 64 rows of 32) and the replicated norms'
    are compressed on their own."""
    from repro_torch.core.engine.lm import shard_layout
    from repro_torch.launch.mesh import make_abstract_mesh
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    split, aligned = shard_layout(_cfg(), mesh)
    layout = {sh.path_str(p): (d, a) for (p, _), d, a in zip(
        sh.flat_with_path(_shape(), is_leaf=lambda x: False), split,
        aligned, strict=True)}
    assert layout["blocks/sub0/mix/wq"] == (2, False)
    assert layout["embed"] == (0, True)
    assert layout["final_ln"] == (None, True)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_a_2x2_checkpoint_resumes_on_2x1(lm_tp_run):
    got, pair, _, _ = lm_tp_run
    want = got[0]["full6"]
    for p in pair:
        r = p["resumed22"]
        _close(r["losses"], want["losses"], ADAMW_TOL)
        _consensus_close(r["consensus"], want["consensus"], ADAMW_TOL)


def test_the_references_checkpoint_resumes_on_2x2(lm_tp_run):
    got, _, ref, _ = lm_tp_run
    want = ref["plain_full6"]
    for g in got:
        _close(g["ref_resumed"]["losses"], want["losses"])
        _consensus_close(g["ref_resumed"]["consensus"],
                         tree_leaves(want["consensus"]), ADAMW_TOL)


def test_the_2x2_file_is_the_reference_format(lm_tp_run):
    """Whole leaves, stacked over the two replicas, under the reference's
    names: the same entries and shapes as the reference's own file."""
    root = lm_tp_run[3]
    from repro_torch.runtime.checkpoint import CheckpointManager

    def entries(d):
        mgr = CheckpointManager(directory=str(root / d))
        with np.load(mgr._path(mgr.latest_step())) as z:
            return {k: z[k].shape for k in z.files}
    port, ref = entries("ckpt22"), entries("ref_ckpt")
    assert port == ref
    assert port["None/embed"] == (2, 64, 32)


# ---------------------------------------------------------------------------
# the sweep, the shim, init_state
# ---------------------------------------------------------------------------
def test_sweep_members_equal_their_standalone_runs(lm_tp_run):
    assert all(g["sweep"] for g in lm_tp_run[0])


def test_the_deprecated_shim_is_the_session(lm_tp_run):
    for g in lm_tp_run[0]:
        for a, b in zip(g["shim"]["params"], g["plain"]["own"]["params"],
                        strict=True):
            assert torch.equal(a, b)


def test_init_state_is_the_cut_of_the_whole(lm_tp_run):
    for g in lm_tp_run[0]:
        assert g["init_cut"]
    whole = [tuple(t.shape) for t in tree_leaves(_shape())]
    halves = lm_tp_run[0][0]["init_shapes"]
    assert sum(np.prod(s) for s in halves) < sum(np.prod(s) for s in whole)
