"""Tensor parallelism inside a replica (launch/steps.py::build_cell,
launch/sharding.py, models/shardctx.py) on the CPU: four gloo ranks,
spawned once for the module, run build_cell's train, prefill and decode
programs on their shards, on ("data", "model") meshes of (1, 2) -- two of
them side by side, ranks {0, 1} and {2, 3} -- and (2, 2).  Every case
starts from the port's init from PRNGKey(0); each rank saves what it got,
gathered whole (``gather_tree``), and the tests hold

  * the sharded train step (qwen3-32b SMOKE with remat off, as the
    reference's own sharded-step test; recurrentgemma-2b SMOKE) to the
    JAX package's jax.jit(make_train_step) from the same values within the
    reference test's tolerances, and to the port's single-rank step within
    STEP_TOL;
  * an Adafactor step whose factored moments span sharded dims (a lower
    min_dim_size_to_factor, so the SMOKE widths factor) to the single-rank
    step within STEP_TOL;
  * prefill and decode logits and every gathered cache leaf to the
    single-rank run within SERVE_TOL, the greedy tokens equal; the cache's
    context slots are split over "model" (40 slots, or a window of 16),
    and a GQA case with 6 q heads over 3 kv heads on 41 slots (kv heads
    replicated, each rank's q heads reading parts of two groups; the
    slots not split) takes the other decode route;
  * dbrx-132b's MoE and rwkv6-1.6b SMOKE under FSDP alone, on (2, 1):
    the batch split over "data", the MoE routed over the whole batch
    (global capacity and slots), to the single-rank runs as above;
  * dbrx-132b and arctic-480b SMOKE expert parallel (their experts split
    over "model"; arctic's dense branch Megatron-style, with its config's
    Adafactor) and rwkv6-1.6b SMOKE head parallel (2 of its 4 heads a
    rank), on (1, 2) and (2, 2), at bf16 activations and at float32: the
    train step as above (the load-balance loss too), prefill and decode,
    and the train step against the reference's jitted step;
  * llava-next-34b and musicgen-large SMOKE, fed embeddings, under the
    dry-run's train rules (``act_seq`` over "model": the embeddings enter
    cut along the sequence, and build_cell gathers them whole) on (1, 2):
    the train step to the single-rank step and to the reference's jitted
    step as above;
  * remesh_params from (2, 2) to (1, 2): gathered, torch.equal to the
    whole params;
  * and, without ranks, constrain as a no-op outside a context.

The rank program is this module's ``_rank_main``; the spawned processes
import this file, so nothing at its top level imports JAX.
"""
import contextlib
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import RankMesh, make_abstract_mesh  # noqa: E402
from repro_torch.models import mlp, shardctx, transformer  # noqa: E402
from repro_torch.optim import get_optimizer, make_adafactor  # noqa: E402
from repro_torch.optim.api import tree_leaves  # noqa: E402
from repro_torch.runtime import elastic, ranks  # noqa: E402

WORLD = 4
SPAWN_TIMEOUT = 240.0
B, S = 8, 32                      # the reference test's global batch, seq
# the sharded step against the single-rank port step: the same arithmetic
# with the row-parallel partial sums rounded to bf16 activations on each
# rank before they are added (the single rank rounds the whole sum once),
# and the vocab-parallel logsumexp summed in another order; AdamW's
# normalized step turns a flipped sign of a near-zero gradient into 2 lr
STEP_TOL = dict(rtol=5e-3, atol=1e-3)
LOSS_RTOL = 1e-3
# at float32 activations the sharded step differs from the single rank's
# only in the order of its sums: optimizer moments (the gradients) within
# F32_SHARE of each leaf's largest; at bf16 each moment leaf within
# BF16_NORM_REL of its norm (tests/test_torch_train.py's bound for
# gradients rounded at other points).  The parameters alone cannot show a
# wrong gradient: AdamW's first step moves every entry by about lr
# whatever the gradient's scale, which STEP_TOL's atol covers.  The
# moments mu = (1 - b1) g and nu = (1 - b2) g^2 scale with it: a halved
# gradient is 0.5 / 0.75 off, a zero or reversed one 1 / 2.  Measured
# largest leaf, bf16: 0.04 against the single-rank port, 0.073 against
# the reference's jitted step (recurrentgemma's nu)
F32_SHARE = 1e-4
BF16_NORM_REL = 0.1
# the update p1 - p0 of each leaf within UPDATE_NORM_REL of the
# single-rank (or reference) step's, norm-relative: an update left out is
# 1 off, a reversed one 2; measured largest leaf 0.25 for AdamW and 0.35
# for Adafactor at bf16 (the signs of near-zero gradients, rounded per
# rank, flip), 2e-4 at float32
UPDATE_NORM_REL = 0.5
# prefill / decode logits and caches against the single-rank run, as a
# share of max|single-rank|: at bf16 activations the partial sums are
# rounded per rank as above, through every layer (chip_smoke.py's LM_TOL
# for two routes that round at other points); at float32, F32_SHARE
SERVE_TOL = 5e-2
BF16_ULP = 2.0 ** -8      # a bf16 cache leaf: one rounding of its inputs
# the reference test's own tolerances for its sharded step
REF_LOSS_RTOL = 1e-3
REF_PARAM_TOL = dict(rtol=5e-3, atol=1e-3)
FACTOR_MIN = 32                   # Adafactor factors the SMOKE widths
# launch/dryrun.py's train rules: the residual stream's sequence over model
SEQ_RULES = dataclasses.replace(sh.DEFAULT_RULES, act_seq=("model",))


def cfg_of(name: str):
    if name.endswith("_seq"):    # trained under SEQ_RULES
        return cfg_of(name[:-4])
    if name == "qwen3":
        return dataclasses.replace(ARCHS["qwen3-32b"].SMOKE, remat=False)
    if name == "rg":
        return ARCHS["recurrentgemma-2b"].SMOKE
    if name.endswith("f32"):     # float32 activations
        return dataclasses.replace(cfg_of(name[:-3]),
                                   activation_dtype="float32")
    if name == "dbrx":
        return ARCHS["dbrx-132b"].SMOKE
    if name == "arctic":
        return ARCHS["arctic-480b"].SMOKE
    if name == "rwkv":
        return ARCHS["rwkv6-1.6b"].SMOKE
    if name == "llava":
        return ARCHS["llava-next-34b"].SMOKE
    if name == "musicgen":
        return ARCHS["musicgen-large"].SMOKE
    if name == "gqa63":           # 6 q heads over 3 kv heads
        return dataclasses.replace(ARCHS["qwen3-32b"].SMOKE, remat=False,
                                   num_heads=6, num_kv_heads=3)
    raise KeyError(name)


def optimizer_of(cfg, kind: str):
    if kind == "adafactor":
        return make_adafactor(min_dim_size_to_factor=FACTOR_MIN)
    return get_optimizer(cfg)


def whole_params(cfg):
    """The port's init from PRNGKey(0), blocks stacked (the train layout)."""
    return transformer.stack_blocks(
        transformer.init_params(cfg, prng.PRNGKey(0), device="cpu"))


def rules_of(cfg_name: str):
    return SEQ_RULES if cfg_name.endswith("_seq") else sh.DEFAULT_RULES


def batch_of(cfg, seed: int = 0):
    """Tokens and labels, or for a model fed embeddings (B, S, d_model)
    standard-normal embeddings and labels."""
    rng = np.random.default_rng(seed)
    out = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S),
                                            dtype=np.int32))
           for k in ("tokens", "labels")}
    if cfg.input_mode == "embeddings":
        out["embeds"] = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model), dtype=np.float32))
        del out["tokens"]
    return out


def decode_inputs(cfg):
    """The tokens fed to the decode steps, one a step and one more."""
    return batch_of(cfg, seed=1)["tokens"][:, :DECODE_STEPS + 1]


def meshes():
    return {"1x2a": RankMesh([[0, 1]], device_type="cpu"),
            "1x2b": RankMesh([[2, 3]], device_type="cpu"),
            "2x2": RankMesh([[0, 1], [2, 3]], device_type="cpu"),
            "2x1a": RankMesh([[0], [1]], device_type="cpu"),
            "2x1b": RankMesh([[2], [3]], device_type="cpu")}


# (case, config, mesh, what): the (1, 2) meshes run side by side
ROUNDS = [
    [("qwen3@1x2", "qwen3", "1x2a", "adamw"),
     ("rg@1x2", "rg", "1x2b", "adamw")],
    [("qwen3@2x2", "qwen3", "2x2", "adamw")],
    [("rg@2x2", "rg", "2x2", "adamw")],
    [("rg_adafactor@2x2", "rg", "2x2", "adafactor")],
    [("qwen3f32@2x2", "qwen3f32", "2x2", "adamw_train")],
    [("rgf32_adafactor@2x2", "rgf32", "2x2", "adafactor")],
    [("rgf32@2x2", "rgf32", "2x2", "adamw")],
    [("dbrx@2x1", "dbrx", "2x1a", "adamw"),
     ("rwkv@2x1", "rwkv", "2x1b", "adamw")],
    [("gqa63@1x2", "gqa63", "1x2a", "adamw"),
     ("rg_adafactor@1x2", "rg", "1x2b", "adafactor")],
    # expert-parallel MoE and head-parallel RWKV6 (get_optimizer: AdamW,
    # arctic's Adafactor)
    [("dbrx@1x2", "dbrx", "1x2a", "adamw"),
     ("rwkv@1x2", "rwkv", "1x2b", "adamw")],
    [("arctic@1x2", "arctic", "1x2a", "adamw"),
     ("rwkvf32@1x2", "rwkvf32", "1x2b", "adamw")],
    [("dbrx@2x2", "dbrx", "2x2", "adamw")],
    [("arctic@2x2", "arctic", "2x2", "adamw")],
    [("rwkv@2x2", "rwkv", "2x2", "adamw")],
    [("dbrxf32@2x2", "dbrxf32", "2x2", "adamw")],
    [("arcticf32@2x2", "arcticf32", "2x2", "adamw")],
    [("arcticf32@1x2", "arcticf32", "1x2a", "adamw")],
    # embeddings cut along the sequence by the train rules
    [("llava_seq@1x2", "llava_seq", "1x2a", "adamw_train"),
     ("musicgen_seq@1x2", "musicgen_seq", "1x2b", "adamw_train")],
]
SERVE_LEN = {"qwen3": 40, "rg": 40, "gqa63": 41, "qwen3f32": 40,
             "rgf32": 40, "dbrx": 40, "rwkv": 40, "arctic": 40,
             "dbrxf32": 40, "arcticf32": 40, "rwkvf32": 40,
             "llava_seq": 40, "musicgen_seq": 40}   # context slots
DECODE_STEPS = 2


# ---------------------------------------------------------------------------
# the rank program
# ---------------------------------------------------------------------------
def _gathered_batch(ctx, t):
    axes = ctx.batch_axes()
    return ctx.gather(t, 0, axes) if axes else t


# bf16 expert-parallel cases whose single-rank runs take their experts:
# a token whose k-th and (k+1)-th experts are nearly tied can take another
# expert when the activations are rounded at other points (the attention
# and dense-branch partial sums, rounded per rank), and its FFN output
# then moves by a share of its hidden state, not by a rounding (measured on
# arctic SMOKE: 2 and 5 of 256 tokens a layer in prefill).  So the
# single-rank run replays the sharded run's experts, as chip_smoke.py's
# phase 11 pins two routes' experts; the float32 cases route alike unpinned
PINNED = ("dbrx@1x2", "dbrx@2x2", "arctic@1x2", "arctic@2x2")


@contextlib.contextmanager
def _recording(ctx, into: list):
    """Record each MoE layer's gate_idx in call order, gathered over the
    batch axes after the calls (a collective of the mesh's ranks)."""
    seen, route = [], mlp.route

    def recording(p, cfg, xf):
        out = route(p, cfg, xf)
        seen.append(out[2])
        return out

    mlp.route = recording
    try:
        yield
    finally:
        mlp.route = route
    into.extend(_gathered_batch(ctx, t) for t in seen)


@contextlib.contextmanager
def _pinned(routes):
    """Run the single-rank model with each MoE call's experts taken from
    ``routes`` in order (the gate weights still this run's probabilities
    at them); nothing pinned when ``routes`` is None."""
    if routes is None:
        yield
        return
    it, route = iter(routes), mlp.route

    def replaying(p, cfg, xf):
        probs, _, _ = route(p, cfg, xf)
        gate_idx = next(it)
        return probs, torch.gather(probs, -1, gate_idx), gate_idx

    mlp.route = replaying
    try:
        yield
    finally:
        mlp.route = route
    assert next(it, None) is None, "fewer MoE calls than the sharded run's"


def _case(name, cfg_name, mesh, opt_kind, serve: bool):
    cfg = cfg_of(cfg_name)
    opt = optimizer_of(cfg, opt_kind)
    train = steps.build_cell(cfg, dataclasses.replace(
        SHAPES["train_4k"], seq_len=S, global_batch=B), mesh,
        rules=rules_of(cfg_name), optimizer=opt)
    n = SERVE_LEN[cfg_name]
    pre = steps.build_cell(cfg, dataclasses.replace(
        SHAPES["prefill_32k"], seq_len=n, global_batch=B), mesh)
    dec = steps.build_cell(cfg, dataclasses.replace(
        SHAPES["decode_32k"], seq_len=n, global_batch=B), mesh)
    ctx = train.ctx
    if not ctx.member:
        return None
    params = whole_params(cfg)
    batch = batch_of(cfg)
    routes = {"train": [], "serve": []}
    pin = name in PINNED
    with _recording(ctx, routes["train"]) if pin else \
            contextlib.nullcontext():
        p1, o1, m1 = train(train.local(0, params),
                           train.local(1, opt.init(params)),
                           train.local(2, batch))
    out = {"routes": routes if pin else None,
           "loss": float(m1["loss"]), "tokens": float(m1["tokens"]),
           "moe_aux": float(m1["moe_aux"]),
           "params": sh.gather_tree(p1, train.in_shardings[0], mesh),
           "opt": sh.gather_tree(o1, train.in_shardings[1], mesh),
           "calls": dict(ctx.calls),
           "local_batch": {k: tuple(v.shape) for k, v in
                           train.local(2, batch).items()}}
    if not serve:
        return out
    local_p = pre.local(0, params)
    with _recording(ctx, routes["serve"]) if pin else \
            contextlib.nullcontext():
        logits, cache = pre(local_p, pre.local(1, {"tokens":
                                                   batch["tokens"]}))
        # decode teacher-forced (the same inputs as the single-rank run,
        # so a rounding that flips a greedy token does not change what
        # follows)
        feed = pre.local(1, {"tokens": decode_inputs(cfg)})["tokens"]
        toks = []
        for t in range(DECODE_STEPS):
            nxt, cache = dec(local_p, cache, feed[:, t:t + 1])
            toks.append(nxt)
        # the logits of one more decode step, through the model itself
        with steps._shard_scope(ctx):
            used = shardctx.gather_params(cfg,
                                          steps._serving_layout(local_p))
            lg, cache = transformer.decode_step(cfg, used, cache,
                                                feed[:, DECODE_STEPS:],
                                                max_len=n)
    out["prefill_logits"] = _gathered_batch(ctx, logits)
    out["tokens_out"] = _gathered_batch(ctx, torch.cat(toks, 1))
    out["decode_logits"] = _gathered_batch(ctx, lg)
    out["cache"] = sh.gather_tree(cache, dec.in_shardings[1], mesh)
    return out


def _rank_main(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    ranks.init(rank, world, f"file://{init_file}")
    ms = meshes()
    got = {}
    for rnd in ROUNDS:
        for name, cfg_name, mesh_name, opt_kind in rnd:
            r = _case(name, cfg_name, ms[mesh_name],
                      opt_kind.split("_")[0], serve=opt_kind == "adamw")
            if r is not None and int(ms[mesh_name].mesh.flatten()[0]) \
                    == rank:
                got[name] = r
    # remesh (2, 2) -> (1, 2): every rank onto the (1, 2) mesh it is in
    cfg = cfg_of("qwen3")
    whole = whole_params(cfg)
    specs = sh.param_specs(cfg, steps.params_shape(cfg), ms["2x2"])
    mine = ms["1x2a"] if rank < 2 else ms["1x2b"]
    moved = elastic.remesh_params(cfg, sh.shard_tree(whole, specs, ms["2x2"]),
                                  mine, old_mesh=ms["2x2"])
    back = sh.gather_tree(moved, sh.param_specs(
        cfg, steps.params_shape(cfg), mine), mine)
    got["remesh"] = all(torch.equal(a, b) for a, b in
                        zip(tree_leaves(back), tree_leaves(whole),
                            strict=True))
    torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    ranks.spawn(_rank_main, WORLD, args=(WORLD, str(root / "pg"), str(root)),
                timeout=SPAWN_TIMEOUT)
    got = {}
    remesh = []
    for r in range(WORLD):
        one = torch.load(root / f"rank{r}.pt", weights_only=False)
        remesh.append(one.pop("remesh"))
        got.update(one)
    got["remesh"] = remesh
    return got


# ---------------------------------------------------------------------------
# single-rank references
# ---------------------------------------------------------------------------
def single_step(cfg_name: str, opt_kind: str, routes=None):
    cfg = cfg_of(cfg_name)
    opt = optimizer_of(cfg, opt_kind)
    params = whole_params(cfg)
    with _pinned(routes):
        return steps.make_train_step(cfg, opt)(params, opt.init(params),
                                               batch_of(cfg))


def single_serve(cfg_name: str, routes=None):
    cfg = cfg_of(cfg_name)
    n = SERVE_LEN[cfg_name]
    params = transformer.init_params(cfg, prng.PRNGKey(0), device="cpu")
    batch = batch_of(cfg)
    feed = decode_inputs(cfg)
    with torch.no_grad(), _pinned(routes):
        logits, cache = transformer.prefill(
            cfg, params, {"tokens": batch["tokens"]}, max_len=n)
        toks = []
        for t in range(DECODE_STEPS + 1):
            lg, cache = transformer.decode_step(cfg, params, cache,
                                                feed[:, t:t + 1])
            toks.append(torch.argmax(lg, -1).to(torch.int32)[:, None])
    return {"prefill_logits": logits, "decode_logits": lg, "cache": cache,
            "tokens_out": torch.cat(toks[:DECODE_STEPS], 1)}


def _close(a, b, tol):
    np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), **tol)


def _within_share(a, b, share):
    err = float((a.float() - b.float()).abs().max())
    assert err <= share * max(float(b.float().abs().max()), 1e-6), err


# the expert- and head-parallel cases
EP_HP_CASES = ["dbrx@1x2", "rwkv@1x2", "arctic@1x2", "rwkvf32@1x2",
               "dbrx@2x2", "arctic@2x2", "rwkv@2x2", "dbrxf32@2x2",
               "arcticf32@2x2", "arcticf32@1x2"]
TRAIN_CASES = ["qwen3@1x2", "rg@1x2", "qwen3@2x2", "rg@2x2", "gqa63@1x2",
               "rg_adafactor@2x2", "rg_adafactor@1x2", "qwen3f32@2x2",
               "rgf32_adafactor@2x2", "dbrx@2x1", "rwkv@2x1"] + EP_HP_CASES \
    + ["llava_seq@1x2", "musicgen_seq@1x2"]


def _norm_rel(a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).double())
                 / max(float(torch.linalg.vector_norm(b.double())), 1e-30))


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_sharded_train_step_equals_the_single_rank_step(tp_run, case):
    got = tp_run[case]
    cfg_name = case.split("@")[0].replace("_adafactor", "")
    p_ref, o_ref, m_ref = single_step(
        cfg_name, "adafactor" if "adafactor" in case else "adamw",
        (got["routes"] or {}).get("train"))
    np.testing.assert_allclose(got["loss"], float(m_ref["loss"]),
                               rtol=LOSS_RTOL)
    # the load-balance loss is whole on every rank, not summed over model
    np.testing.assert_allclose(got["moe_aux"], float(m_ref["moe_aux"]),
                               rtol=LOSS_RTOL)
    assert got["tokens"] == float(m_ref["tokens"]) == B * S
    p0 = whole_params(cfg_of(cfg_name))
    for (path, a), b, z in zip(sh.flat_with_path(got["params"]),
                               tree_leaves(p_ref), tree_leaves(p0),
                               strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
        _close(a, b, STEP_TOL)
        assert _norm_rel(a.float() - z.float(), b.float() - z.float()) \
            < UPDATE_NORM_REL, path
    for a, b in zip(tree_leaves(got["opt"]), tree_leaves(o_ref),
                    strict=True):
        assert a.shape == b.shape
        if not a.is_floating_point():
            assert torch.equal(a, b)
        elif cfg_of(cfg_name).activation_dtype == "float32":
            _within_share(a, b, F32_SHARE)
        else:
            assert _norm_rel(a, b) < BF16_NORM_REL


@pytest.mark.parametrize("case", ["llava_seq@1x2", "musicgen_seq@1x2"])
def test_train_rules_cut_the_embeddings_along_the_sequence(tp_run, case):
    """Under SEQ_RULES each rank is handed half the sequence of the
    embeddings (build_cell gathers it whole before the model), the labels
    whole."""
    d = cfg_of(case.split("@")[0]).d_model
    assert tp_run[case]["local_batch"] == {"embeds": (B, S // 2, d),
                                           "labels": (B, S)}


def test_adafactor_moments_factor_over_sharded_dims(tp_run):
    """The Adafactor cases factor leaves whose rows or columns a mesh
    axis splits: their vr / vc still equal the single-rank step's."""
    cfg = cfg_of("rg")
    opt = optimizer_of(cfg, "adafactor")
    pshape = steps.params_shape(cfg)
    oshape = opt.init(pshape)
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    ospecs = sh.opt_state_specs(cfg, oshape, pshape, mesh)
    split = [sh.path_str(p) for p, s in sh.flat_with_path(ospecs)
             if p[-1] in ("vr", "vc") and sh.spec_axes(s)]
    assert any(p.endswith("w_a/vr") for p in split), split
    assert any("model" in sh.spec_axes(s) for p, s in
               sh.flat_with_path(ospecs) if p[-1] == "vc")
    for case in ("rgf32_adafactor@2x2", "rg_adafactor@2x2",
                 "rg_adafactor@1x2"):
        name = case.split("_")[0]
        _, o_ref, _ = single_step(name, "adafactor")
        got = tp_run[case]["opt"]
        for (path, a), b in zip(sh.flat_with_path(got),
                                tree_leaves(o_ref), strict=True):
            if path[-1] not in ("vr", "vc"):
                continue
            if name.endswith("f32"):
                _within_share(a, b, F32_SHARE)
            else:
                assert _norm_rel(a, b) < BF16_NORM_REL, path


@pytest.mark.parametrize("case", ["qwen3@1x2", "rg@1x2", "qwen3@2x2",
                                  "rg@2x2", "gqa63@1x2", "rgf32@2x2",
                                  "dbrx@2x1", "rwkv@2x1"] + EP_HP_CASES)
def test_sharded_prefill_and_decode_equal_the_single_rank_run(tp_run, case):
    got = tp_run[case]
    name = case.split("@")[0]
    ref = single_serve(name, (got["routes"] or {}).get("serve"))
    tol = F32_SHARE if name.endswith("f32") else SERVE_TOL
    _within_share(got["prefill_logits"], ref["prefill_logits"], tol)
    _within_share(got["decode_logits"], ref["decode_logits"], tol)
    agree = float((got["tokens_out"] == ref["tokens_out"]).float().mean())
    assert agree == 1.0 if name.endswith("f32") else agree >= 0.75, agree
    flat_got = sh.flat_with_path(got["cache"])
    flat_ref = sh.flat_with_path(ref["cache"])
    assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
    for (path, a), (_, b) in zip(flat_got, flat_ref, strict=True):
        if not isinstance(b, torch.Tensor):
            assert a == b, path
        elif b.is_floating_point():
            assert a.shape == b.shape and a.dtype == b.dtype, path
            _within_share(a, b, tol if b.dtype == torch.float32 else
                          max(tol, BF16_ULP))
        else:
            assert torch.equal(a, b), path


def test_decode_routes_and_collectives(tp_run):
    """qwen3 on (1, 2): the 40 context slots split over model (the
    renormalized route); gqa63's 41 slots stay whole on each rank."""
    mesh = make_abstract_mesh((1, 2), ("data", "model"))
    for name, split in (("qwen3", True), ("gqa63", False)):
        cfg = cfg_of(name)
        cspecs = sh.cache_specs(cfg, steps.cache_shape(
            cfg, B, SERVE_LEN[name]), mesh)
        k_spec = dict(sh.flat_with_path(cspecs))[("blocks", "sub0", "k")]
        assert (k_spec[2] == "model") is split
    assert tp_run["qwen3@1x2"]["calls"].get("model", 0) > 0
    assert tp_run["qwen3@2x2"]["calls"].get("data", 0) > 0


def test_remesh_params_2x2_to_1x2_is_exact(tp_run):
    assert tp_run["remesh"] == [True] * WORLD


# ---------------------------------------------------------------------------
# against the JAX package's jitted step
# ---------------------------------------------------------------------------
def _to_reference(jcfg, params):
    import jax
    import jax.numpy as jnp

    from repro.models.transformer import init_params
    flat = {sh.path_str(p): t for p, t in sh.flat_with_path(params)}
    shapes = jax.eval_shape(lambda k: init_params(jcfg, k),
                            jax.random.PRNGKey(0))

    def pick(path, leaf):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                       for k in path)
        t = flat[key]
        assert tuple(t.shape) == tuple(leaf.shape), key
        return jnp.asarray(t.float().numpy()).astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(pick, shapes)


# arctic against the reference at float32 activations: at bf16 its
# routing flips on a few tokens between the two packages (see PINNED)
@pytest.mark.parametrize("case", ["qwen3@2x2", "qwen3@1x2", "rg@2x2",
                                  "dbrx@1x2", "dbrx@2x2", "arcticf32@1x2",
                                  "arcticf32@2x2", "rwkv@1x2", "rwkv@2x2",
                                  "llava_seq@1x2", "musicgen_seq@1x2"])
def test_sharded_train_step_equals_the_references_jitted_step(tp_run, case):
    import jax

    from repro.configs.registry import ARCHS as JARCHS
    from repro.launch import steps as jsteps
    from repro.optim import get_optimizer as jget_optimizer
    name = case.split("@")[0]
    base = name[:-3] if name.endswith("f32") else name.removesuffix("_seq")
    jcfg = {"qwen3": dataclasses.replace(JARCHS["qwen3-32b"].SMOKE,
                                         remat=False),
            "rg": JARCHS["recurrentgemma-2b"].SMOKE,
            "dbrx": JARCHS["dbrx-132b"].SMOKE,
            "arctic": JARCHS["arctic-480b"].SMOKE,
            "rwkv": JARCHS["rwkv6-1.6b"].SMOKE,
            "llava": JARCHS["llava-next-34b"].SMOKE,
            "musicgen": JARCHS["musicgen-large"].SMOKE}[base]
    if name.endswith("f32"):
        jcfg = dataclasses.replace(jcfg, activation_dtype="float32")
    cfg = cfg_of(name)
    params = _to_reference(jcfg, whole_params(cfg))
    opt = jget_optimizer(jcfg)
    batch = {k: np.asarray(v) for k, v in batch_of(cfg).items()}
    p_ref, o_ref, m_ref = jax.jit(jsteps.make_train_step(jcfg, opt))(
        params, opt.init(params), batch)
    got = tp_run[case]
    np.testing.assert_allclose(got["loss"], float(m_ref["loss"]),
                               rtol=REF_LOSS_RTOL)

    def flat(tree):
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                         for k in path): torch.from_numpy(
                             np.array(v, np.float32))
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    ref_p, ref_o = flat(p_ref), flat(o_ref)
    p0 = {sh.path_str(p): t.float()
          for p, t in sh.flat_with_path(whole_params(cfg))}
    for path, a in sh.flat_with_path(got["params"]):
        key = sh.path_str(path)
        b = ref_p[key]
        np.testing.assert_allclose(a.float().numpy(), b.numpy(),
                                   **REF_PARAM_TOL)
        assert _norm_rel(a.float() - p0[key], b - p0[key]) \
            < UPDATE_NORM_REL, key
    # the gradients, through the moments: AdamW's mu = (1 - b1) g and
    # nu = (1 - b2) g^2, Adafactor's v = g^2 + eps at its first step
    moments = [(p, a) for p, a in sh.flat_with_path(got["opt"])
               if p[0] in ("mu", "nu", "v")]
    assert len(moments) == (2 if moments[0][0][0] in ("mu", "nu") else 1) \
        * len(p0)
    for path, a in moments:
        assert _norm_rel(a, ref_o[sh.path_str(path)]) < BF16_NORM_REL, path


# ---------------------------------------------------------------------------
# without ranks
# ---------------------------------------------------------------------------
def test_constrain_is_a_no_op_outside_a_context():
    x = torch.randn(2, 3, 4)
    assert shardctx.current() is None
    assert shardctx.constrain(x, "act_batch", "act_seq", "act_embed") is x
    assert shardctx.copy_to_model(x) is x
    assert shardctx.reduce_from_model(x) is x
    assert shardctx.gather_from_model(x, -1) is x
    assert shardctx.gather_params(cfg_of("qwen3"), {"w": x})["w"] is x


