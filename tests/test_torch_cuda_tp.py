"""Tensor parallelism on the card: two gloo ranks sharing one NVIDIA GPU
(one card holds one NCCL rank, so a multi-rank run on one card is gloo,
which reduces CUDA tensors only through all_reduce).  Spawned once for
the module, the ranks run

  * the four collective forms of models/shardctx.py on CUDA tensors with
    autograd -- copy_to_model (identity / all-reduce), reduce_from_model
    (all-reduce / identity), gather_from_model (all-gather /
    reduce-scatter) and the FSDP gather over "data" -- against the sums
    they must give, forward and backward;
  * build_cell's train step for qwen3-32b and recurrentgemma-2b SMOKE on
    ("data", "model") = (1, 2), the recurrences through the kernel
    (forward and reverse-time launches on each rank's W/2 channels),
    against each rank's own single-rank step: the parameters within
    STEP_TOL, and what scales with the gradient -- the optimizer moments
    and the update p1 - p0 -- within MOMENT_NORM_REL and UPDATE_NORM_REL;
  * recurrentgemma-2b SMOKE's prefill with attention_impl="flash" on
    (1, 2): the flash kernel on each rank's 2 local q heads, the scan on
    its 32 local channels, logits within SERVE_TOL of the single-rank
    kernel route, and a decode step;
  * dbrx-132b SMOKE expert parallel (its 4 experts 2 a rank) and
    rwkv6-1.6b SMOKE head parallel (2 of its 4 heads a rank), both at
    float32 activations (the two runs then route alike, and at d_model
    64 the bf16 roundings of the single-rank and the sharded GEMMs, which
    cuBLAS tiles differently, move a moment leaf by up to 0.1
    norm-relative): the train step as above, and
    prefill (dbrx's flash on its local heads) plus two decode steps, the
    logits within SERVE_TOL of the single-rank run;
  * TreeSync over tensor-parallel replicas, in a second spawn of four
    ranks: recurrentgemma-2b SMOKE's LMSession on (data, model) = (2, 2)
    with an int8 root, 4 steps: losses finite, step 1's within 1e-3 of
    the mean of the single-rank losses on the replicas' rows, the shards
    of a model coordinate equal after every sync, the scan launches the
    code's count at the local width.

Every test here needs an NVIDIA GPU and skips without one; the file
imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_tp.py
"""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import RankMesh  # noqa: E402
from repro_torch.models import shardctx, transformer  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.optim.api import tree_leaves  # noqa: E402
from repro_torch.runtime import ranks  # noqa: E402

pytestmark = pytest.mark.cuda

WORLD = 2
B, S = 4, 32
# tests/test_torch_tp.py's tolerances for the same comparisons (its
# BF16_NORM_REL for the moments)
STEP_TOL = dict(rtol=5e-3, atol=1e-3)
MOMENT_NORM_REL = 0.1
UPDATE_NORM_REL = 0.5
SERVE_TOL = 5e-2


def _norm_rel(a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).double())
                 / max(float(torch.linalg.vector_norm(b.double())), 1e-30))


def _cfg(name):
    if name == "qwen3":
        return dataclasses.replace(ARCHS["qwen3-32b"].SMOKE, remat=False)
    if name == "dbrx":
        return dataclasses.replace(ARCHS["dbrx-132b"].SMOKE,
                                   activation_dtype="float32")
    if name == "rwkv":
        return dataclasses.replace(ARCHS["rwkv6-1.6b"].SMOKE,
                                   activation_dtype="float32")
    return ARCHS["recurrentgemma-2b"].SMOKE


def _batch(cfg, dev):
    g = torch.Generator().manual_seed(0)
    return {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                             dtype=torch.int32).to(dev)
            for k in ("tokens", "labels")}


def _collectives(rank, dev):
    """The four forms, forward and backward, on CUDA tensors."""
    rules = sh.DEFAULT_RULES
    out = {}
    with shardctx.activation_sharding(RankMesh([[0, 1]]), rules):
        w = float(rank + 1)
        x = torch.full((3, 4), w, device=dev, requires_grad=True)
        (shardctx.copy_to_model(x) * w).sum().backward()
        out["copy"] = (float(x.detach().max()), float(x.grad.min()),
                       float(x.grad.max()))                     # 1+2 = 3
        x = torch.full((3, 4), w, device=dev, requires_grad=True)
        y = shardctx.reduce_from_model(x)
        (y * w).sum().backward()
        y = y.detach()
        out["reduce"] = (float(y.min()), float(y.max()),
                         float(x.grad.min()), float(x.grad.max()))
        x = torch.full((3, 2), w, device=dev, requires_grad=True)
        y = shardctx.gather_from_model(x, -1)
        (y * torch.arange(4, device=dev) * w).sum().backward()
        out["gather"] = (y.detach().cpu(), x.grad.detach().cpu())
    with shardctx.activation_sharding(RankMesh([[0], [1]]), rules):
        x = torch.full((2, 3), float(rank + 1), device=dev,
                       requires_grad=True)
        y = shardctx.gather_from_batch(x, 0)
        (y * (rank + 1)).sum().backward()
        out["fsdp"] = (y.detach().cpu(), x.grad.detach().cpu())
    return out


def _train(name, mesh, dev):
    from repro_torch.kernels.rglru import kernel as rg
    cfg = _cfg(name)
    opt = get_optimizer(cfg)
    cell = steps.build_cell(cfg, dataclasses.replace(
        SHAPES["train_4k"], seq_len=S, global_batch=B), mesh, optimizer=opt)
    params = transformer.stack_blocks(
        transformer.init_params(cfg, prng.PRNGKey(0), device=dev))
    batch = _batch(cfg, dev)
    state = opt.init(params)
    p_ref, o_ref, m_ref = steps.make_train_step(cfg, opt)(params, state,
                                                          batch)
    rg.LAUNCHES = 0
    p0 = cell.local(0, params)
    p1, o1, m1 = cell(p0, cell.local(1, state), cell.local(2, batch))
    launches = rg.LAUNCHES
    mine = sh.shard_tree(p_ref, cell.in_shardings[0], mesh)
    worst = max(float(((a.float() - b.float()).abs()
                       - STEP_TOL["rtol"] * b.float().abs()).max())
                for a, b in zip(tree_leaves(p1), tree_leaves(mine),
                                strict=True))
    update = max(_norm_rel(a.float() - z.float(), b.float() - z.float())
                 for a, b, z in zip(tree_leaves(p1), tree_leaves(mine),
                                    tree_leaves(p0), strict=True))
    o_mine = sh.shard_tree(o_ref, cell.in_shardings[1], mesh)
    moments = max((_norm_rel(a, b), sh.path_str(path)) for (path, a), b in
                  zip(sh.flat_with_path(o1), tree_leaves(o_mine),
                      strict=True) if path[0] in ("mu", "nu"))
    return {"loss": (float(m1["loss"]), float(m_ref["loss"])),
            "excess": worst, "update": update, "moments": moments,
            "scan_launches": launches}


def _prefill(mesh, dev):
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rglru import kernel as rg
    cfg = dataclasses.replace(_cfg("rg"), attention_impl="flash")
    n = S + 8
    pre = steps.build_cell(cfg, dataclasses.replace(
        SHAPES["prefill_32k"], seq_len=n, global_batch=B), mesh)
    dec = steps.build_cell(cfg, dataclasses.replace(
        SHAPES["decode_32k"], seq_len=n, global_batch=B), mesh)
    params = transformer.init_params(cfg, prng.PRNGKey(0), device=dev)
    tokens = _batch(cfg, dev)["tokens"]
    with torch.no_grad():
        ref, _ = transformer.prefill(cfg, params, {"tokens": tokens},
                                     max_len=n)
    fa.LAUNCHES = rg.LAUNCHES = 0
    fa.LAUNCHES_BY_SHAPE.clear()
    rg.LAUNCHES_BY_SHAPE.clear()
    local = pre.local(0, params)
    logits, cache = pre(local, {"tokens": tokens})
    out = {"flash": fa.LAUNCHES, "scan": rg.LAUNCHES,
           "routes": (dict(fa.LAUNCHES_BY_ROUTE), dict(rg.LAUNCHES_BY_ROUTE)),
           "shapes": (dict(fa.LAUNCHES_BY_SHAPE), dict(rg.LAUNCHES_BY_SHAPE)),
           "err": float((logits - ref).abs().max()),
           "scale": float(ref.abs().max())}
    nxt, cache = dec(local, cache, torch.argmax(logits, -1).to(
        torch.int32)[:, None])
    out["decode"] = (tuple(nxt.shape), int(cache["pos"]))
    return out


def _serve(name, mesh, dev):
    """Prefill and two decode steps of an expert- or head-parallel model
    against the single-rank run; dbrx's attention through flash."""
    from repro_torch.kernels.flash_attention import kernel as fa
    cfg = _cfg(name)
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, attention_impl="flash")
    n = S + 8
    pre = steps.build_cell(cfg, dataclasses.replace(
        SHAPES["prefill_32k"], seq_len=n, global_batch=B), mesh)
    dec = steps.build_cell(cfg, dataclasses.replace(
        SHAPES["decode_32k"], seq_len=n, global_batch=B), mesh)
    params = transformer.init_params(cfg, prng.PRNGKey(0), device=dev)
    tokens = _batch(cfg, dev)["tokens"]
    feed = _batch(cfg, dev)["labels"][:, :2]
    with torch.no_grad():
        ref, cache = transformer.prefill(cfg, params, {"tokens": tokens},
                                         max_len=n)
        for t in range(2):
            ref_d, cache = transformer.decode_step(cfg, params, cache,
                                                   feed[:, t:t + 1])
    fa.LAUNCHES = 0
    local = pre.local(0, params)
    logits, cache = pre(local, {"tokens": tokens})
    flash = fa.LAUNCHES
    ctx = pre.ctx
    for t in range(2):
        with steps._shard_scope(ctx), torch.no_grad():
            used = shardctx.gather_params(cfg, steps._serving_layout(local))
            lg, cache = transformer.decode_step(cfg, used, cache,
                                                feed[:, t:t + 1], max_len=n)
    return {"flash": flash, "attn": sum(k == "attn"
                                        for k in cfg.layer_kinds())
            if cfg.attention_impl == "flash" else 0,
            "err": float((logits - ref).abs().max()),
            "scale": float(ref.abs().max()),
            "decode_err": float((lg - ref_d).abs().max()),
            "decode_scale": float(ref_d.abs().max())}


def _card_rank(rank, world, init_file, out_dir):
    ranks.init(rank, world, f"file://{init_file}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = RankMesh([[0, 1]])
    got = {"collectives": _collectives(rank, dev),
           "train_qwen3": _train("qwen3", mesh, dev),
           "train_rg": _train("rg", mesh, dev),
           "prefill": _prefill(mesh, dev),
           "train_dbrx": _train("dbrx", mesh, dev),
           "train_rwkv": _train("rwkv", mesh, dev),
           "serve_dbrx": _serve("dbrx", mesh, dev),
           "serve_rwkv": _serve("rwkv", mesh, dev)}
    torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


LM_STEPS = 4


def _lm_rank(rank, world, init_file, out_dir):
    """TreeSync over (data, model) = (2, 2): recurrentgemma-2b SMOKE, int8
    root, periods (2,), LM_STEPS steps."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.api import Problem, Schedule, Session, Topology
    from repro_torch.core.engine import lm as lm_mod
    from repro_torch.data.lm import lm_batch
    from repro_torch.kernels.rglru import kernel as rg
    ranks.init(rank, world, f"file://{init_file}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _cfg("rg")
    opt = get_optimizer(cfg)
    mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
    sess = Session.compile(
        Problem.lm(cfg, opt, batch=B, seq=S, seed=0),
        Topology.from_mesh(mesh, sync_axes=("data",), periods=(2,)),
        Schedule(compression=("int8",)), backend="mesh", mesh=mesh,
        device=dev)
    start = sess.init_state(0)
    # step 1's loss is the replicas' mean of the single-rank loss on each
    # replica's rows, from the whole state the shards were cut from
    whole = lm_mod.init_lm_state(cfg, opt, prng.PRNGKey(0), device=dev)
    with torch.no_grad():
        ref_loss = sum(float(transformer.forward_train(
            cfg, whole.params, lm_batch(
                cfg, B, S, 0, seed=0, rows=lm_mod.replica_rows(B, 2, r),
                device=dev))[1]["loss"]) for r in range(2)) / 2
    del whole
    equal = []

    def after(step, state):
        if step % 2 == 0:           # a sync step: the replicas agree
            for t in tree_leaves(state.params):
                peer = sess.comm.world[0].gather_rows(
                    t.detach().float().reshape(1, -1))
                equal.append(bool(torch.equal(peer[0], peer[1])))

    rg.LAUNCHES = 0
    rg.LAUNCHES_BY_SHAPE.clear()
    res = sess.run(steps=LM_STEPS, warm_start=start, on_state=after)
    torch.save({"losses": [h["loss"] for h in res.history],
                "ref_loss": ref_loss, "equal": equal,
                "scan": rg.LAUNCHES, "shapes": dict(rg.LAUNCHES_BY_SHAPE),
                "consensus": [tuple(t.shape)
                              for t in tree_leaves(res.consensus())]},
               os.path.join(out_dir, f"lm{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def card_run(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import _build
    _build.build_all()
    root = tmp_path_factory.mktemp("tp_card")
    ranks.spawn(_card_rank, WORLD, args=(WORLD, str(root / "pg"), str(root)),
                timeout=600)
    return [torch.load(root / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def lm_card_run(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import _build
    _build.build_all()
    root = tmp_path_factory.mktemp("lm_tp_card")
    ranks.spawn(_lm_rank, 4, args=(4, str(root / "pg"), str(root)),
                timeout=600)
    return [torch.load(root / f"lm{r}.pt", weights_only=False)
            for r in range(4)]


def test_collective_forms_on_card_tensors(card_run):
    for rank, got in enumerate(card_run):
        c = got["collectives"]
        assert c["copy"] == (rank + 1.0, 3.0, 3.0)          # grads summed
        w = rank + 1.0
        assert c["reduce"] == (3.0, 3.0, w, w)             # identity back
        y, g = c["gather"]
        assert torch.equal(y, torch.tensor([[1.0, 1, 2, 2]] * 3))
        # d/dx of sum(y * arange(4) * w_r) over ranks: columns 2r, 2r+1
        # of arange(4) * (1 + 2)
        want = torch.tensor([[2.0 * rank, 2.0 * rank + 1]] * 3) * 3.0
        assert torch.equal(g, want)
        y, g = c["fsdp"]
        assert torch.equal(y, torch.tensor([[1.0] * 3] * 2 + [[2.0] * 3] * 2))
        assert torch.equal(g, torch.full((2, 3), 3.0))


@pytest.mark.parametrize("name", ["qwen3", "rg", "dbrx", "rwkv"])
def test_sharded_train_step_on_the_card(card_run, name):
    cfg = _cfg(name)
    for got in card_run:
        r = got[f"train_{name}"]
        assert abs(r["loss"][0] - r["loss"][1]) <= 1e-3 * abs(r["loss"][1])
        assert r["excess"] <= STEP_TOL["atol"], r["excess"]
        assert r["moments"][0] < MOMENT_NORM_REL, r["moments"]
        assert r["update"] < UPDATE_NORM_REL, r["update"]
        # forward and reverse-time launch per recurrent layer, and the
        # remat recompute in a block
        pattern, n_full, tail = transformer.block_layout(cfg)
        in_blocks = n_full * sum(k == "rec" for k in pattern)
        want = (3 if cfg.remat else 2) * in_blocks + 2 * tail.count("rec")
        assert r["scan_launches"] == want


def test_flash_and_scan_run_on_local_shards(card_run):
    cfg = _cfg("rg")
    n_attn = sum(k == "attn" for k in cfg.layer_kinds())
    n_rec = sum(k == "rec" for k in cfg.layer_kinds())
    for got in card_run:
        p = got["prefill"]
        assert (p["flash"], p["scan"]) == (n_attn, n_rec), p
        # each rank's 2 of 4 q heads over the one kv head, 32 of 64 channels
        assert p["shapes"] == ({(B, S, S, 2, 1, cfg.head_dim): n_attn},
                               {(B, S, cfg.lru_width // 2): n_rec}), p
        assert p["err"] <= SERVE_TOL * p["scale"], p
        assert p["decode"] == ((B, 1), S + 1)


@pytest.mark.parametrize("name", ["dbrx", "rwkv"])
def test_expert_and_head_parallel_serving_on_the_card(card_run, name):
    for got in card_run:
        r = got[f"serve_{name}"]
        assert r["flash"] == r["attn"], r
        assert r["err"] <= SERVE_TOL * r["scale"], r
        assert r["decode_err"] <= SERVE_TOL * r["decode_scale"], r


def test_treesync_over_tensor_parallel_replicas_on_the_card(lm_card_run):
    cfg = _cfg("rg")
    pattern, n_full, tail = transformer.block_layout(cfg)
    in_blocks = n_full * sum(k == "rec" for k in pattern)
    per_step = (3 if cfg.remat else 2) * in_blocks + 2 * tail.count("rec")
    whole = [tuple(t.shape) for t in tree_leaves(steps.params_shape(cfg))]
    for got in lm_card_run:
        assert len(got["losses"]) == LM_STEPS
        assert all(x == x and abs(x) < 1e9 for x in got["losses"])
        assert abs(got["losses"][0] - got["ref_loss"]) <= \
            1e-3 * abs(got["ref_loss"])
        assert got["equal"] and all(got["equal"])
        assert got["scan"] == LM_STEPS * per_step
        assert got["shapes"] == {(B // 2, S, cfg.lru_width // 2):
                                 LM_STEPS * per_step}
        assert got["consensus"] == whole
