"""The sharding variants of launch/perf.py::VARIANTS that build_cell lays
out beyond the baseline rules, on four gloo ranks spawned once for the
module as ("data", "model") = (2, 2):

  * ZeRO-1 (``zero1``: parameters whole over "data", the optimizer state
    split over it): the train step of qwen3-32b SMOKE (AdamW) and of
    arctic-480b SMOKE cut to 3 layers at float32 activations with an
    Adafactor that factors the SMOKE widths (its factored ``vc`` of the
    experts' weights is cut along another dim than the parameter, so the
    state is laid out anew around the update); each rank updates its cut
    of a parameter and all-gathers the cuts;
  * pure FSDP (``fsdp_pure``: the batch over "data" and "model", no
    tensor parallelism, the parameters split over both and gathered in
    one all-gather over both): qwen3-32b SMOKE's train step, prefill and
    two decode steps;
  * ``serve_headdata`` (the cache's batch whole over "data", the tokens
    split over it): qwen3-32b and recurrentgemma-2b SMOKE's prefill (its
    cache handed out whole over "data") and decode (each rank decodes its
    rows of the tokens against its rows of the cache, and the new cache
    entries of every row are gathered over "data").

Each train step is held against the port's single-rank step and the JAX
package's jitted step, each prefill and decode against the single-rank
run and the reference's jitted prefill and decode, within
tests/test_torch_tp.py's tolerances.  The rank program is this module's
``_rank_main``; the spawned processes import this file, so nothing at
its top level imports JAX.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch import perf, steps  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import RankMesh  # noqa: E402
from repro_torch.models import shardctx, transformer  # noqa: E402
from repro_torch.optim.api import tree_leaves  # noqa: E402
from repro_torch.runtime import ranks  # noqa: E402
from test_torch_tp import (B, BF16_NORM_REL, BF16_ULP, F32_SHARE,  # noqa: E402
                           FACTOR_MIN, LOSS_RTOL, REF_LOSS_RTOL,
                           REF_PARAM_TOL, SERVE_TOL, STEP_TOL,
                           UPDATE_NORM_REL, S, _close, _norm_rel,
                           _to_reference, _within_share, batch_of)
from test_torch_tp import cfg_of as tp_cfg_of  # noqa: E402
from test_torch_tp import optimizer_of  # noqa: E402

WORLD = 4
SPAWN_TIMEOUT = 240.0
N_SLOTS = 40              # the serving cells' context slots
DECODE_STEPS = 2
# (case, config, variant, optimizer, serve)
CASES = [("qwen3@zero1", "qwen3", "zero1", "adamw", False),
         ("arctic3f32@zero1", "arctic3f32", "zero1", "adafactor", False),
         ("qwen3@fsdp_pure", "qwen3", "fsdp_pure", "adamw", True),
         ("qwen3@serve_headdata", "qwen3", "serve_headdata", None, True),
         ("rg@serve_headdata", "rg", "serve_headdata", None, True)]


def cfg_of(name: str):
    if name == "arctic3f32":      # an odd depth: the zero1 cut is no layer
        return dataclasses.replace(tp_cfg_of("arcticf32"), num_layers=3)
    return tp_cfg_of(name)


def whole_params(cfg):
    return transformer.stack_blocks(
        transformer.init_params(cfg, prng.PRNGKey(0), device="cpu"))


def decode_inputs(cfg):
    return batch_of(cfg, seed=1)["tokens"][:, :DECODE_STEPS + 1]


def _cut(name: str, n: int):
    return dataclasses.replace(SHAPES[name], seq_len=n, global_batch=B)


# ---------------------------------------------------------------------------
# the rank program
# ---------------------------------------------------------------------------
def _whole_rows(ctx, t, entry):
    axes = sh.entry_axes(entry)
    return ctx.gather(t, 0, axes) if axes else t


def _serve(cfg, rules, mesh, params):
    pre = steps.build_cell(cfg, _cut("prefill_32k", N_SLOTS), mesh,
                           rules=rules)
    dec = steps.build_cell(cfg, _cut("decode_32k", N_SLOTS), mesh,
                           rules=rules)
    tok_ax = sh._batch_axes(mesh, rules, B)
    cache_ax = sh._batch_axes(mesh, rules, B, "cache_batch")
    local_p = pre.local(0, params)
    logits, cache = pre(local_p, pre.local(
        1, {"tokens": batch_of(cfg)["tokens"]}))
    feed = dec.local(2, decode_inputs(cfg))
    toks = []
    for t in range(DECODE_STEPS):
        nxt, cache = dec(local_p, cache, feed[:, t:t + 1])
        toks.append(nxt)
    # the logits of one more decode step, through the model itself under
    # the decode program's context
    with steps._shard_scope(dec.ctx):
        used = shardctx.gather_params(cfg, steps._serving_layout(local_p))
        lg, cache = transformer.decode_step(cfg, used, cache,
                                            feed[:, DECODE_STEPS:],
                                            max_len=N_SLOTS)
    return {"prefill_logits": _whole_rows(pre.ctx, logits, tok_ax),
            "tokens_out": _whole_rows(dec.ctx, torch.cat(toks, 1), tok_ax),
            "decode_logits": _whole_rows(dec.ctx, lg, tok_ax),
            "cache": sh.gather_tree(cache, dec.in_shardings[1], mesh),
            "decode_batch_axes": dec.ctx.batch_axes(),
            "decode_cache_axes": sh.entry_axes(cache_ax),
            "calls": dict(dec.ctx.calls)}


def _case(cfg_name, variant, opt_kind, serve, mesh):
    cfg = cfg_of(cfg_name)
    rules = perf.VARIANTS[variant]["rules"]
    params = whole_params(cfg)
    out = {}
    if opt_kind is not None:
        opt = optimizer_of(cfg, opt_kind)
        train = steps.build_cell(cfg, _cut("train_4k", S), mesh, rules=rules,
                                 optimizer=opt)
        ctx = train.ctx
        ctx.reset_timing()
        p1, o1, m1 = train(train.local(0, params),
                           train.local(1, opt.init(params)),
                           train.local(2, batch_of(cfg)))
        out.update(loss=float(m1["loss"]), tokens=float(m1["tokens"]),
                   moe_aux=float(m1["moe_aux"]),
                   params=sh.gather_tree(p1, train.in_shardings[0], mesh),
                   opt=sh.gather_tree(o1, train.in_shardings[1], mesh),
                   calls=dict(ctx.calls),
                   collectives=len(ctx.collectives),
                   local_opt=[tuple(t.shape) for t in tree_leaves(o1)],
                   local_params=[tuple(t.shape) for t in tree_leaves(p1)],
                   batch_axes=ctx.batch_axes(), tp=ctx.tp)
    if serve:
        out.update(_serve(cfg, rules, mesh, params))
    return out


def _rank_main(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    ranks.init(rank, world, f"file://{init_file}")
    mesh = RankMesh([[0, 1], [2, 3]], device_type="cpu")
    got = {name: _case(cfg_name, variant, opt_kind, serve, mesh)
           for name, cfg_name, variant, opt_kind, serve in CASES}
    if rank == 0:
        torch.save(got, os.path.join(out_dir, "rank0.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("variants")
    ranks.spawn(_rank_main, WORLD, args=(WORLD, str(root / "pg"), str(root)),
                timeout=SPAWN_TIMEOUT)
    return torch.load(root / "rank0.pt", weights_only=False)


# ---------------------------------------------------------------------------
# single-rank and reference runs
# ---------------------------------------------------------------------------
def single_step(cfg_name: str, opt_kind: str):
    cfg = cfg_of(cfg_name)
    opt = optimizer_of(cfg, opt_kind)
    params = whole_params(cfg)
    return steps.make_train_step(cfg, opt)(params, opt.init(params),
                                           batch_of(cfg))


def single_serve(cfg_name: str):
    cfg = cfg_of(cfg_name)
    params = transformer.init_params(cfg, prng.PRNGKey(0), device="cpu")
    feed = decode_inputs(cfg)
    with torch.no_grad():
        logits, cache = transformer.prefill(
            cfg, params, {"tokens": batch_of(cfg)["tokens"]},
            max_len=N_SLOTS)
        toks = []
        for t in range(DECODE_STEPS + 1):
            lg, cache = transformer.decode_step(cfg, params, cache,
                                                feed[:, t:t + 1])
            toks.append(torch.argmax(lg, -1).to(torch.int32)[:, None])
    return {"prefill_logits": logits, "decode_logits": lg, "cache": cache,
            "tokens_out": torch.cat(toks[:DECODE_STEPS], 1)}


def reference_cfg(cfg_name: str):
    from repro.configs.registry import ARCHS as JARCHS
    jcfg = {"qwen3": dataclasses.replace(JARCHS["qwen3-32b"].SMOKE,
                                         remat=False),
            "rg": JARCHS["recurrentgemma-2b"].SMOKE,
            "arctic3f32": dataclasses.replace(
                JARCHS["arctic-480b"].SMOKE, num_layers=3,
                activation_dtype="float32")}[cfg_name]
    return jcfg


def reference_optimizer(jcfg, opt_kind: str):
    from repro.optim import get_optimizer as jget_optimizer
    from repro.optim.adafactor import make_adafactor as jmake_adafactor
    if opt_kind == "adafactor":
        return jmake_adafactor(min_dim_size_to_factor=FACTOR_MIN)
    return jget_optimizer(jcfg)


def _flat_reference(tree):
    import jax
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                     for k in path): torch.from_numpy(np.array(v, np.float32))
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _opt_of(case):
    return next(c[3] for c in CASES if c[0] == case)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
TRAIN_CASES = ["qwen3@zero1", "arctic3f32@zero1", "qwen3@fsdp_pure"]
SERVE_CASES = ["qwen3@fsdp_pure", "qwen3@serve_headdata",
               "rg@serve_headdata"]


def test_the_variants_lay_out_what_their_rules_say(runs):
    """ZeRO-1: each moment a rank holds is half of its parameter shard
    (every leaf of qwen3 SMOKE has a dim "data" divides), the parameters
    whole over "data"; pure FSDP: "model" is a batch axis, no tensor
    parallelism, one gather over both axes; serve_headdata: each rank
    decodes its rows (the batch over "data") against a cache whole over
    "data", whose new entries it gathers over "data"."""
    z = runs["qwen3@zero1"]
    assert z["tp"] and z["batch_axes"] == ("data",)
    n = len(z["local_params"])
    mu = z["local_opt"][:n]
    assert [int(np.prod(m)) * 2 for m in mu] == \
        [int(np.prod(p)) for p in z["local_params"]]
    f = runs["qwen3@fsdp_pure"]
    assert not f["tp"] and f["batch_axes"] == ("data", "model")
    assert f["calls"].get("data+model", 0) > 0
    assert f["decode_batch_axes"] == ("data", "model")
    assert f["decode_cache_axes"] == ("data", "model")
    for case in ("qwen3@serve_headdata", "rg@serve_headdata"):
        assert runs[case]["decode_batch_axes"] == ("data",)
        assert runs[case]["decode_cache_axes"] == ()
        assert runs[case]["calls"].get("data", 0) > 0


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_variant_train_step_equals_the_single_rank_step(runs, case):
    got = runs[case]
    cfg_name = case.split("@")[0]
    cfg = cfg_of(cfg_name)
    p_ref, o_ref, m_ref = single_step(cfg_name, _opt_of(case))
    np.testing.assert_allclose(got["loss"], float(m_ref["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["moe_aux"], float(m_ref["moe_aux"]),
                               rtol=LOSS_RTOL)
    assert got["tokens"] == float(m_ref["tokens"]) == B * S
    p0 = whole_params(cfg)
    for (path, a), b, z in zip(sh.flat_with_path(got["params"]),
                               tree_leaves(p_ref), tree_leaves(p0),
                               strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        _close(a, b, STEP_TOL)
        assert _norm_rel(a.float() - z.float(), b.float() - z.float()) \
            < UPDATE_NORM_REL, path
    for (path, a), b in zip(sh.flat_with_path(got["opt"]),
                            tree_leaves(o_ref), strict=True):
        assert a.shape == b.shape, path
        if not a.is_floating_point():
            assert torch.equal(a, b)
        elif cfg.activation_dtype == "float32":
            _within_share(a, b, F32_SHARE)
        else:
            assert _norm_rel(a, b) < BF16_NORM_REL, path


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_variant_train_step_equals_the_references_jitted_step(runs, case):
    import jax

    from repro.launch import steps as jsteps
    cfg_name = case.split("@")[0]
    cfg = cfg_of(cfg_name)
    jcfg = reference_cfg(cfg_name)
    params = _to_reference(jcfg, whole_params(cfg))
    opt = reference_optimizer(jcfg, _opt_of(case))
    batch = {k: np.asarray(v) for k, v in batch_of(cfg).items()}
    p_ref, o_ref, m_ref = jax.jit(jsteps.make_train_step(jcfg, opt))(
        params, opt.init(params), batch)
    got = runs[case]
    np.testing.assert_allclose(got["loss"], float(m_ref["loss"]),
                               rtol=REF_LOSS_RTOL)
    ref_p, ref_o = _flat_reference(p_ref), _flat_reference(o_ref)
    p0 = {sh.path_str(p): t.float()
          for p, t in sh.flat_with_path(whole_params(cfg))}
    for path, a in sh.flat_with_path(got["params"]):
        key = sh.path_str(path)
        b = ref_p[key]
        np.testing.assert_allclose(a.float().numpy(), b.numpy(),
                                   **REF_PARAM_TOL)
        assert _norm_rel(a.float() - p0[key], b - p0[key]) \
            < UPDATE_NORM_REL, key
    # the gradients, through the moments (AdamW's mu and nu, Adafactor's
    # v or its factored vr and vc)
    moments = [(p, a) for p, a in sh.flat_with_path(got["opt"])
               if p[0] in ("mu", "nu", "v")]
    assert len(moments) == len(ref_o) - 1
    for path, a in moments:
        assert _norm_rel(a, ref_o[sh.path_str(path)]) < BF16_NORM_REL, path


@pytest.mark.parametrize("case", SERVE_CASES)
def test_variant_prefill_and_decode_equal_the_single_rank_run(runs, case):
    got = runs[case]
    ref = single_serve(case.split("@")[0])
    _within_share(got["prefill_logits"], ref["prefill_logits"], SERVE_TOL)
    _within_share(got["decode_logits"], ref["decode_logits"], SERVE_TOL)
    agree = float((got["tokens_out"] == ref["tokens_out"]).float().mean())
    assert agree >= 0.75, agree
    flat_got = sh.flat_with_path(got["cache"])
    flat_ref = sh.flat_with_path(ref["cache"])
    assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
    for (path, a), (_, b) in zip(flat_got, flat_ref, strict=True):
        if not isinstance(b, torch.Tensor):
            assert a == b, path
        elif b.is_floating_point():
            assert a.shape == b.shape and a.dtype == b.dtype, path
            _within_share(a, b, SERVE_TOL if b.dtype == torch.float32
                          else max(SERVE_TOL, BF16_ULP))
        else:
            assert torch.equal(a, b), path


@pytest.mark.parametrize("case", SERVE_CASES)
def test_variant_prefill_and_decode_equal_the_references_jitted_run(runs,
                                                                    case):
    """The same prompt and teacher-forced tokens through the JAX
    package's jitted prefill and decode_step from the same weights."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as jtr
    cfg_name = case.split("@")[0]
    cfg = cfg_of(cfg_name)
    jcfg = reference_cfg(cfg_name)
    params = _to_reference(jcfg, whole_params(cfg))
    logits, cache = jax.jit(jtr.prefill, static_argnums=(0, 3))(
        jcfg, params, {"tokens": jnp.asarray(batch_of(cfg)["tokens"])},
        N_SLOTS)
    step = jax.jit(jtr.decode_step, static_argnums=0)
    feed = decode_inputs(cfg).numpy()
    for t in range(DECODE_STEPS + 1):
        lg, cache = step(jcfg, params, cache, jnp.asarray(feed[:, t:t + 1]))
    got = runs[case]
    _within_share(got["prefill_logits"],
                  torch.from_numpy(np.asarray(logits, np.float32)),
                  SERVE_TOL)
    _within_share(got["decode_logits"],
                  torch.from_numpy(np.asarray(lg, np.float32)), SERVE_TOL)
