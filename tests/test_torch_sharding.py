"""The sharding rules of launch/sharding.py against the JAX package's, entry
for entry: for every architecture of the registry (SMOKE and FULL) on the
abstract meshes (16, 16), (8, 16), (4, 2), (2, 2) and (1, 2) of ("data",
"model") and (2, 16, 16) of ("pod", "data", "model"):

  * params_shape's shapes and dtypes (meta tensors from the init
    functions, against jax.eval_shape of the reference's init);
  * param_specs and its dropped list, explain_shardings;
  * opt_state_specs under AdamW and Adafactor;
  * cache_specs and batch_specs (train, prefill and decode inputs);
  * core/treesync.py's tp_rules and replica_specs;
  * under every rule set of launch/perf.py::VARIANTS on (2, 2), the
    parameter, optimizer-state and cache specs, the cache's but for one
    departure: an axis its batch dim takes is not given to a later dim
    (the reference maps ``model`` twice under ``fsdp_pure``, which jax
    refuses with a DuplicateSpecError).

Then tests/test_sharding.py's six spec tests and tests/test_runtime.py's
fold_batch / shrink_survivors tests, replayed on the port.  Everything
here is shapes and names: no ranks, no tensors are drawn.
"""
import dataclasses

import jax
import pytest
from jax.sharding import PartitionSpec as JP

torch = pytest.importorskip("torch")

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.core import treesync as jtsy  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_abstract_mesh as jmesh  # noqa: E402
from repro.optim import make_adafactor as jadafactor  # noqa: E402
from repro.optim import make_adamw as jadamw  # noqa: E402

from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.core import treesync as tsy  # noqa: E402
from repro_torch.launch import perf  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_abstract_mesh  # noqa: E402
from repro_torch.optim import make_adafactor, make_adamw  # noqa: E402
from repro_torch.runtime.elastic import (fold_batch,  # noqa: E402
                                         shrink_survivors)

P = sh.P
MESHES = [((16, 16), ("data", "model")), ((8, 16), ("data", "model")),
          ((4, 2), ("data", "model")), ((2, 2), ("data", "model")),
          ((1, 2), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
CASES = [(arch, which) for arch in ARCHS for which in ("SMOKE", "FULL")]


def jflat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                     for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]}


def tflat(tree):
    return {sh.path_str(p): v for p, v in sh.flat_with_path(tree)}


def assert_same_specs(got: dict, want: dict, what: str):
    assert list(got) == list(want), what
    for k in got:
        assert isinstance(got[k], P), (what, k)
        assert tuple(got[k]) == tuple(want[k]), (what, k, got[k], want[k])


@pytest.mark.parametrize("arch,which", CASES)
def test_every_spec_is_the_references(arch, which):
    cfg, jcfg = getattr(ARCHS[arch], which), getattr(JARCHS[arch], which)
    ps, jps = steps.params_shape(cfg), jsteps.params_shape(jcfg)
    got, want = tflat(ps), jflat(jps)
    assert list(got) == list(want)
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype)
    opts = [(make_adamw().init(ps), jax.eval_shape(jadamw().init, jps)),
            (make_adafactor().init(ps),
             jax.eval_shape(jadafactor().init, jps))]
    cs, jcs = steps.cache_shape(cfg, 8, 64), jsteps.cache_shape(jcfg, 8, 64)
    batches = [(steps.input_specs(cfg, dataclasses.replace(SHAPES[n],
                                                           global_batch=32)),
                jsteps.input_specs(jcfg, dataclasses.replace(
                    JSHAPES[n], global_batch=32)))
               for n in ("train_4k", "prefill_32k", "decode_32k")]
    for shape, axes in MESHES:
        m, jm = make_abstract_mesh(shape, axes), jmesh(shape, axes)
        where = f"{arch} {which} {shape}"
        d1, d2 = [], []
        assert_same_specs(tflat(sh.param_specs(cfg, ps, m, dropped=d1)),
                          jflat(jsh.param_specs(jcfg, jps, jm, dropped=d2)),
                          where)
        assert d1 == d2, where
        assert sh.explain_shardings(cfg, ps, m) == \
            jsh.explain_shardings(jcfg, jps, jm), where
        for os_, jos in opts:
            assert_same_specs(
                tflat(sh.opt_state_specs(cfg, os_, ps, m)),
                jflat(jsh.opt_state_specs(jcfg, jos, jps, jm)), where)
        assert_same_specs(tflat(sh.cache_specs(cfg, cs, m)),
                          jflat(jsh.cache_specs(jcfg, jcs, jm)), where)
        for b, jb in batches:
            got_b = sh.batch_specs(cfg, m, b)
            want_b = jsh.batch_specs(jcfg, jm, jb)
            assert {k: tuple(v) for k, v in got_b.items()} == \
                {k: tuple(v) for k, v in want_b.items()}, where
        ts, jts = tsy.TreeSyncConfig(), jtsy.TreeSyncConfig()
        assert_same_specs(tflat(tsy.replica_specs(cfg, ps, m, ts)),
                          jflat(jtsy.replica_specs(jcfg, jps, jm, jts)),
                          where)
    assert tsy.tp_rules() == sh.AxisRules(**dataclasses.asdict(
        jtsy.tp_rules()))


def _without(entry, axes):
    left = tuple(a for a in sh.entry_axes(entry) if a not in axes)
    return None if not left else left[0] if len(left) == 1 else left


@pytest.mark.parametrize("variant", list(perf.VARIANTS))
def test_variant_specs_are_the_references_but_a_twice_mapped_axis(variant):
    rules = perf.VARIANTS[variant].get("rules", sh.DEFAULT_RULES)
    jrules = jsh.AxisRules(**dataclasses.asdict(rules))
    m, jm = make_abstract_mesh((2, 2), ("data", "model")), \
        jmesh((2, 2), ("data", "model"))
    batch = sh.entry_axes(sh._batch_axes(m, rules, 8, "cache_batch"))
    for arch in ("qwen3-32b", "recurrentgemma-2b", "rwkv6-1.6b",
                 "dbrx-132b"):
        cfg, jcfg = ARCHS[arch].SMOKE, JARCHS[arch].SMOKE
        ps, jps = steps.params_shape(cfg), jsteps.params_shape(jcfg)
        assert_same_specs(tflat(sh.param_specs(cfg, ps, m, rules)),
                          jflat(jsh.param_specs(jcfg, jps, jm, jrules)),
                          arch)
        for os_, jos in ((make_adamw().init(ps),
                          jax.eval_shape(jadamw().init, jps)),
                         (make_adafactor(min_dim_size_to_factor=32).init(ps),
                          jax.eval_shape(jadafactor(
                              min_dim_size_to_factor=32).init, jps))):
            assert_same_specs(
                tflat(sh.opt_state_specs(cfg, os_, ps, m, rules)),
                jflat(jsh.opt_state_specs(jcfg, jos, jps, jm, jrules)),
                arch)
        got = tflat(sh.cache_specs(cfg, steps.cache_shape(cfg, 8, 64), m,
                                   rules))
        want = jflat(jsh.cache_specs(jcfg, jsteps.cache_shape(jcfg, 8, 64),
                                     jm, jrules))
        assert list(got) == list(want)
        for k, spec in want.items():
            lead = 1 if k.startswith("blocks/") else 0
            rows = k.rsplit("/", 1)[-1] != "slot_pos"
            expect = tuple(e if rows and d == lead else _without(e, batch)
                           for d, e in enumerate(spec))
            assert tuple(got[k]) == expect, (arch, k, got[k], spec)
            twice = len(sh.spec_axes(spec)) > len(set(sh.spec_axes(spec)))
            assert (tuple(got[k]) != tuple(spec)) == (
                twice or (not rows and bool(set(batch)
                                            & set(sh.spec_axes(spec))))), k


def test_p_is_a_tuple_written_as_the_reference_writes_it():
    spec = P(None, "data", ("pod", "data"))
    assert isinstance(spec, tuple) and tuple(spec) == (None, "data",
                                                       ("pod", "data"))
    assert repr(spec) == "P(None, 'data', ('pod', 'data'))"
    assert tuple(spec[:-1]) == (None, "data")


def test_a_list_block_takes_the_stacked_spec_without_its_leading_entry():
    cfg = ARCHS["recurrentgemma-2b"].SMOKE
    m = make_abstract_mesh((2, 2), ("data", "model"))
    specs = sh.param_specs(cfg, steps.params_shape(cfg), m)
    listed = {"blocks": [{}, {}], "embed": None}
    got = sh.for_layout(specs, listed)
    assert len(got["blocks"]) == 2
    assert got["blocks"][1]["sub0"]["mix"]["w_in"] == \
        P(*specs["blocks"]["sub0"]["mix"]["w_in"][1:])
    assert got["embed"] == specs["embed"]


def test_local_shard_cuts_by_mixed_radix_coordinates():
    m = make_abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    t = torch.arange(8 * 6).reshape(8, 6)
    spec = P(("pod", "data"), "model")
    got = sh.local_shard(t, spec, m, {"pod": 1, "data": 0, "model": 1})
    assert torch.equal(got, t[4:6, 3:6])


# ---------------------------------------------------------------------------
# tests/test_sharding.py's spec tests, on the port
# ---------------------------------------------------------------------------
def _specs(cfg, shape=(16, 16), dropped=None):
    mesh = make_abstract_mesh(shape, ("data", "model"))
    return tflat(sh.param_specs(cfg, steps.params_shape(cfg), mesh,
                                dropped=dropped))


def test_qwen3_full_specs_2d():
    specs = _specs(ARCHS["qwen3-32b"].FULL)
    assert specs["blocks/sub0/mix/wq"] == P(None, "data", "model")
    assert specs["blocks/sub0/mix/wo"] == P(None, "model", "data")
    assert specs["blocks/sub0/ffn/w_gate"] == P(None, "data", "model")
    assert specs["blocks/sub0/ffn/w_down"] == P(None, "model", "data")
    assert specs["embed"] == P("model", "data")
    assert specs["blocks/sub0/ln1"] == P(None, None)
    # kv fused dim: kv=8 heads < 16-way axis -> head-alignment guard trips
    assert specs["blocks/sub0/mix/wk"] == P(None, "data", None)


def test_head_alignment_guard_yi():
    specs = _specs(ARCHS["yi-34b"].FULL)
    assert specs["blocks/sub0/mix/wq"] == P(None, "data", None)
    assert specs["blocks/sub0/ffn/w_gate"] == P(None, "data", "model")


def test_moe_expert_parallel():
    specs = _specs(ARCHS["arctic-480b"].FULL)
    assert specs["blocks/sub0/ffn/w_gate"] == P(None, "model", "data", None)
    assert specs["blocks/sub0/ffn/w_down"] == P(None, "model", None, "data")
    assert specs["blocks/sub0/ffn/router"] == P(None, "data", None)
    assert specs["blocks/sub0/ffn/dense/w_gate"] == P(None, "data", "model")


def test_opt_state_inherits_param_specs():
    cfg = ARCHS["qwen3-32b"].SMOKE
    mesh = make_abstract_mesh((4, 2), ("data", "model"))
    pshape = steps.params_shape(cfg)
    ospecs = tflat(sh.opt_state_specs(cfg, steps.opt_shape(cfg, make_adamw()),
                                      pshape, mesh))
    pspecs = tflat(sh.param_specs(cfg, pshape, mesh))
    assert ospecs["mu/blocks/sub0/mix/wq"] == pspecs["blocks/sub0/mix/wq"]
    assert ospecs["step"] == P()


def test_adafactor_factored_state_specs():
    cfg = ARCHS["arctic-480b"].FULL
    mesh = make_abstract_mesh((16, 16), ("data", "model"))
    pshape = steps.params_shape(cfg)
    ospecs = tflat(sh.opt_state_specs(
        cfg, steps.opt_shape(cfg, make_adafactor()), pshape, mesh))
    assert ospecs["v/blocks/sub0/ffn/w_gate/vr"] == P(None, "model", "data")
    assert ospecs["v/blocks/sub0/ffn/w_gate/vc"] == P(None, "model", None)


def test_divisibility_fallback():
    cfg = dataclasses.replace(ARCHS["qwen3-32b"].SMOKE, d_model=60)
    dropped = []
    specs = _specs(cfg, dropped=dropped)
    assert specs["blocks/sub0/mix/wq"][1] is None  # 60 % 16 != 0
    assert any(d[1] == "embed" for d in dropped)


# ---------------------------------------------------------------------------
# tests/test_runtime.py's elastic sizing, on the port's abstract mesh
# ---------------------------------------------------------------------------
def test_fold_batch_invariance():
    m1 = make_abstract_mesh((16, 16), ("data", "model"))
    m2 = make_abstract_mesh((8, 16), ("data", "model"))
    assert fold_batch(256, m1)["per_replica"] * 16 == 256
    assert fold_batch(256, m2)["per_replica"] * 8 == 256
    with pytest.raises(ValueError):
        fold_batch(100, m1)  # 100 % 16 != 0


@pytest.mark.parametrize("n,lost,mp,want", [(512, 3, 16, 496),
                                             (512, 16, 16, 496),
                                             (256, 1, 16, 240)])
def test_shrink_survivors_respects_tp_group(n, lost, mp, want):
    assert shrink_survivors(n, lost=lost, model_parallel=mp) == want


def test_the_production_mesh_needs_its_world():
    from repro_torch.launch.mesh import (MULTI_POD_AXES, MULTI_POD_SHAPE,
                                         SINGLE_POD_SHAPE,
                                         make_production_mesh)
    from repro.launch import mesh as jm
    assert (SINGLE_POD_SHAPE, MULTI_POD_SHAPE, MULTI_POD_AXES) == \
        (jm.SINGLE_POD_SHAPE, jm.MULTI_POD_SHAPE, jm.MULTI_POD_AXES)
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs a world of {n} ranks; "
                                             f"the world has 1"):
            make_production_mesh(multi_pod=multi)
