"""The port's checkpoint manager and single-card elastic helpers
(``repro_torch/runtime/{checkpoint,elastic}.py``) against the JAX
package's: the cases of ``tests/test_runtime.py``, the same file format
in both directions (a file one package writes restores in the other with
equal arrays, bf16 included), and the helpers' values.  Arrays are
compared exactly: a checkpoint stores bits."""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import checkpoint as jckpt
from repro.runtime import elastic as jelastic
from repro_torch.runtime import elastic
from repro_torch.runtime.checkpoint import CheckpointManager, resume_or_init


def _state(v=0.0):
    return {"params": {"w": torch.full((8, 8), v), "b": torch.zeros(8)},
            "step": torch.tensor(int(v), dtype=torch.int32),
            "bf16": torch.full((4,), v, dtype=torch.bfloat16)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).cpu().numpy()
    return np.asarray(x, np.float64)


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    s = _state(3.0)
    mgr.save(3, s, metadata={"loss": 1.23})
    step, restored = mgr.restore(_state())
    assert step == 3
    for a, b in zip(_leaves(restored), _leaves(s), strict=True):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    assert restored["bf16"].dtype == torch.bfloat16
    assert mgr.metadata()["loss"] == 1.23


def test_checkpoint_retention_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(float(s)))
    assert mgr.all_steps() == [3, 4]
    step, r = mgr.restore(_state())
    assert step == 4 and float(r["params"]["w"][0, 0]) == 4.0


def test_checkpoint_ignores_partial_writes(tmp_path):
    """A crash mid-save (an orphan .npz without its sidecar) is never
    resumed."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _state(1.0))
    (tmp_path / "step_0000000009.npz").write_bytes(b"not a checkpoint")
    assert mgr.latest_step() == 1
    step, _ = mgr.restore(_state())
    assert step == 1


def test_checkpoint_mixed_dtype_nested_roundtrip(tmp_path):
    """Exact dtype and structure through the npz flatten: nested dict /
    list / tuple with bf16 (no numpy dtype: stored as uint16), f32, f64,
    int32 and uint32 leaves, torch tensors and numpy arrays mixed."""
    s = {"k": np.arange(2, dtype=np.uint32),
         "nest": {"a": [torch.full((3,), 1.5, dtype=torch.bfloat16),
                        torch.full((2, 2), -2.0)],
                  "b": (torch.tensor(7, dtype=torch.int32),
                        np.float64(0.25))},
         "c": np.arange(4, dtype=np.float64)}
    template = {"k": np.zeros(2, np.uint32),
                "nest": {"a": [torch.zeros(3, dtype=torch.bfloat16),
                               torch.zeros((2, 2))],
                         "b": (torch.zeros((), dtype=torch.int32),
                               np.float64(0.0))},
                "c": np.zeros(4, np.float64)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, s)
    step, r = mgr.restore(template)
    assert step == 5
    assert isinstance(r["nest"]["b"], tuple)
    for a, b in zip(_leaves(r), _leaves(s), strict=True):
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(_f64(a), _f64(b))
    dtypes = mgr.metadata()["dtypes"]
    assert dtypes["nest/a/0"] == "bfloat16" and dtypes["k"] == "uint32"


def test_checkpoint_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    mgr.save(1, _state(1.0))
    mgr.save(2, _state(2.0))
    mgr.wait()
    assert mgr.latest_step() == 2


def test_checkpoint_async_save_takes_its_copy_at_the_call(tmp_path):
    """An async save snapshots at ``save``: writing the caller's tensor in
    place afterwards does not reach the file (the reference's
    ``jax.tree.map(np.asarray, state)``)."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    s = _state(1.0)
    mgr.save(1, s)
    s["params"]["w"].fill_(9.0)
    s["bf16"].fill_(9.0)
    mgr.wait()
    _, r = mgr.restore(_state())
    assert float(r["params"]["w"].max()) == 1.0
    assert float(r["bf16"].max()) == 1.0


def test_checkpoint_async_saves_under_thread_switching(tmp_path):
    """Many async saves back to back, with the interpreter switching
    threads as often as it can: each save waits for the one in flight, so
    every step is published in order and retention keeps the last k."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
        for s in range(1, 41):
            mgr.save(s, _state(float(s)))
        mgr.wait()
    finally:
        sys.setswitchinterval(old)
    assert mgr._thread is None
    assert mgr.all_steps() == [38, 39, 40]
    _, r = mgr.restore(_state())
    assert float(r["params"]["w"][0, 0]) == 40.0


def test_checkpoint_async_save_failure_surfaces(tmp_path, monkeypatch):
    """A failed background write does not die silently on the save
    thread: wait() (or the next save) re-raises it."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    mgr.save(1, _state(1.0))
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.wait()
    assert mgr.latest_step() is None          # nothing published
    monkeypatch.undo()
    mgr.save(2, _state(2.0))                  # the manager recovers
    mgr.wait()
    assert mgr.latest_step() == 2


def test_checkpoint_keep_one_always_restorable(tmp_path):
    """keep=1: after every save the newest complete checkpoint restores
    (GC never deletes the step it just published), and retired steps are
    gone, payload and sidecar."""
    mgr = CheckpointManager(str(tmp_path), keep=1)
    for s in (1, 2, 3, 4, 5):
        mgr.save(s, _state(float(s)))
        assert mgr.all_steps() == [s]
        step, r = mgr.restore(_state())
        assert step == s and float(r["params"]["w"][0, 0]) == float(s)
    assert len(list(tmp_path.glob("step_*"))) == 2   # one npz + one json
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state(), step=1)                # retired explicitly
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path), keep=0)


def test_resume_or_init(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    step, s = resume_or_init(mgr, lambda: _state(0.0))
    assert step == 0
    mgr.save(7, _state(7.0))
    step, s = resume_or_init(mgr, lambda: _state(0.0))
    assert step == 7 and float(s["params"]["w"][0, 0]) == 7.0


# ---------------------------------------------------------------------------
# one file format for both packages
# ---------------------------------------------------------------------------
def _pair(v):
    """The same values as a port tree (torch) and a reference tree (jax),
    with the payload's shape: alpha, w, key, res/<i>, plus a bf16 leaf."""
    rng = np.random.default_rng(int(v))
    alpha = rng.standard_normal(24).astype(np.float32)
    w = rng.standard_normal(6).astype(np.float32)
    key = np.array([0, int(v)], np.uint32)
    res = [rng.standard_normal((4, 6)).astype(np.float32) for _ in range(2)]
    half = rng.standard_normal(5).astype(np.float32)
    port = {"alpha": torch.from_numpy(alpha), "w": torch.from_numpy(w),
            "key": key, "res": [torch.from_numpy(r) for r in res],
            "half": torch.from_numpy(half).to(torch.bfloat16)}
    ref = {"alpha": jnp.asarray(alpha), "w": jnp.asarray(w),
           "key": jnp.asarray(key), "res": [jnp.asarray(r) for r in res],
           "half": jnp.asarray(half, jnp.bfloat16)}
    return port, ref


def test_the_reference_reads_what_the_port_writes(tmp_path):
    port, ref = _pair(3)
    CheckpointManager(str(tmp_path / "p")).save(4, port, {"round": 4})
    jckpt.CheckpointManager(str(tmp_path / "j")).save(4, ref, {"round": 4})
    with np.load(tmp_path / "p" / "step_0000000004.npz") as zp, \
            np.load(tmp_path / "j" / "step_0000000004.npz") as zj:
        assert sorted(zp.files) == sorted(zj.files) == \
            ["alpha", "half", "key", "res/0", "res/1", "w"]
        for k in zj.files:
            assert zp[k].dtype == zj[k].dtype
            np.testing.assert_array_equal(zp[k], zj[k])
    meta_p = json.loads((tmp_path / "p" / "step_0000000004.json").read_text())
    meta_j = json.loads((tmp_path / "j" / "step_0000000004.json").read_text())
    assert meta_p["dtypes"] == meta_j["dtypes"]
    assert meta_p["dtypes"]["half"] == "bfloat16"
    template = jax.tree.map(lambda t: np.zeros(t.shape, t.dtype), ref)
    step, got = jckpt.CheckpointManager(str(tmp_path / "p")).restore(
        template)
    assert step == 4
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref),
                    strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_the_port_reads_what_the_reference_writes(tmp_path):
    port, ref = _pair(5)
    jckpt.CheckpointManager(str(tmp_path)).save(2, ref, {"round": 2})
    template = {"alpha": torch.zeros(24), "w": torch.zeros(6),
                "key": np.zeros(2, np.uint32),
                "res": [torch.zeros((4, 6)) for _ in range(2)],
                "half": torch.zeros(5, dtype=torch.bfloat16)}
    mgr = CheckpointManager(str(tmp_path))
    step, got = mgr.restore(template)
    assert step == 2 and mgr.metadata()["round"] == 2
    for a, b in zip(_leaves(got), _leaves(port), strict=True):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# elastic helpers on one card
# ---------------------------------------------------------------------------
def test_shrink_survivors_equals_the_reference():
    for n, lost, mp in ((512, 3, 16), (512, 16, 16), (256, 1, 16),
                        (8, 0, 1), (8, 8, 2), (96, 5, 8)):
        assert elastic.shrink_survivors(n, lost, mp) == \
            jelastic.shrink_survivors(n, lost, mp)
    assert elastic.shrink_survivors(512, lost=3, model_parallel=16) == 496


def test_remesh_state_roundtrip_is_value_identical():
    """Host -> device -> host -> device is value-identical, bf16 included,
    and every leaf lands where the devices tree puts it."""
    s = _state(5.0)
    placed = elastic.remesh_state(elastic.to_host(s),
                                  elastic.replicated("cpu", s))
    back = elastic.to_host(placed)
    assert isinstance(back["params"]["w"], np.ndarray)
    assert back["bf16"].dtype == torch.bfloat16
    for a, b in zip(_leaves(placed), _leaves(s), strict=True):
        assert a.device.type == "cpu" and a.dtype == b.dtype
        assert torch.equal(a, b)
    for a, b in zip(_leaves(back), _leaves(s), strict=True):
        np.testing.assert_array_equal(_f64(a), _f64(b))


def test_remesh_params_and_fold_batch_need_the_mesh_backend():
    """remesh_params cuts a whole tree by the new mesh's parameter specs
    (launch/sharding.py): on one process, rank 0's shards of a (1, 2)
    mesh; fold_batch reads the data x pod sizes of a mesh (any object
    with DeviceMesh's mesh_dim_names and shape)."""
    import types

    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.launch.steps import params_shape
    from repro_torch.models.transformer import init_params, stack_blocks
    cfg = ARCHS["qwen3-32b"].SMOKE
    whole = stack_blocks(init_params(cfg, 0, device="cpu"))
    new = RankMesh([[0, 1]], device_type="cpu")
    moved = elastic.remesh_params(cfg, whole, new)
    specs = sharding.param_specs(cfg, params_shape(cfg), new)
    assert tuple(moved["embed"].shape) == (cfg.vocab_size // 2, cfg.d_model)
    assert torch.equal(moved["embed"], whole["embed"][:cfg.vocab_size // 2])
    for a, b in zip(_leaves(moved), _leaves(sharding.shard_tree(
            whole, specs, new, {"data": 0, "model": 0})), strict=True):
        assert torch.equal(a, b)
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                 shape=(2, 4, 8))
    assert elastic.fold_batch(256, mesh) == {"data_parallel": 8,
                                             "per_replica": 32}
    with pytest.raises(ValueError, match="must divide data parallelism 8"):
        elastic.fold_batch(12, mesh)
