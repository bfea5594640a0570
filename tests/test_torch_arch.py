"""Every architecture of the registry in the port against the JAX package:
the ten configs (FULL and SMOKE) field by field with their parameter
counts, ``init_params`` from a threefry key against ``jax.jit(
init_params)``, and, for the six dense architectures the rest of the
tests do not cover (musicgen-large and llava-next-34b fed embeddings,
qwen3's qk-norm, qwen2.5's QKV bias, h2o-danube's window, yi), the serving
and training entry points at SMOKE size: ``forward_train``'s loss and
gradients, prefill logits and every cache leaf, four decode steps,
``launch/serve.generate``'s tokens and one ``make_train_step`` with
``get_optimizer(cfg)`` at both activation dtypes.  MoE and RWKV6 have files of their own
(tests/test_torch_moe.py, tests/test_torch_rwkv6.py), which use this
file's helpers.

Each reference program is built once per (architecture, activation
dtype) and shared by the tests.  Tolerances: TOL / F32_TOL at float32
activations (the same arithmetic in two libraries, summed in other
orders); at bfloat16 the two libraries round their intermediates at
different points (jax op by op inside silu, gelu, sigmoid; torch once per
op), so logits agree to BF16_REL of their largest magnitude (observed up
to 1.7e-2), the loss to BF16_LOSS_RTOL and each gradient leaf to
BF16_GRAD_NORM_REL of its norm (observed up to 3.2e-2).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.data.lm import lm_batch  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.optim import get_optimizer as jget_optimizer  # noqa: E402
from repro_torch.api.convert import lm_params_from_reference  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import grads_of, make_train_step  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.optim.api import tree_leaves  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
F32_TOL = dict(rtol=2e-4, atol=2e-6)
BF16_REL = 3e-2
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_NORM_REL = 0.1
# parameters after one optimizer step: the first AdamW step moves a
# weight by lr * g / (|g| + 1e-8), which turns a gradient's float32
# summation error into up to lr of movement where |g| is near 1e-8
# (observed 2.1e-5 at lr 3e-4 on dbrx-smoke); the gradients themselves
# are held to F32_TOL by the forward_train tests
STEP_TOL = dict(rtol=2e-4, atol=0.1 * 3e-4)
# a first AdamW step moves a weight by lr * (g / (|g| + 1e-8) + wd * w):
# at most lr (3e-4) plus the decay's lr * 0.1 * |w|, in either package
BF16_STEP_ATOL = 2 * 3e-4 * 1.1
ULPS = 4
DENSE = ("musicgen-large", "qwen3-32b", "qwen2.5-32b", "h2o-danube-1.8b",
         "yi-34b", "llava-next-34b")
ACTS = ("float32", "bfloat16")
B, S, GEN = 2, 32, 4


# ---------------------------------------------------------------------------
# helpers (tests/test_torch_moe.py and tests/test_torch_rwkv6.py use them)
# ---------------------------------------------------------------------------
def configs(arch, act=None, **kw):
    """The (reference, port) SMOKE configs of ``arch``, with the
    activation dtype ``act`` when given."""
    extra = dict(kw, **({} if act is None else {"activation_dtype": act}))
    return (dataclasses.replace(JARCHS[arch].SMOKE, **extra),
            dataclasses.replace(ARCHS[arch].SMOKE, **extra))


def tensor(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def numpy(t):
    t = t.detach()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def flat(tree, path=""):
    """{path: leaf} of a nested dict / list tree."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{path}[{i}]"))
        return out
    return {path: tree}


def stacked(tree):
    """The port's per-block list (params or cache) as the reference's
    stacked ``blocks``."""
    def stack(ts):
        if isinstance(ts[0], dict):
            return {k: stack([t[k] for t in ts]) for k in ts[0]}
        return torch.stack(ts)
    out = dict(tree)
    if isinstance(out.get("blocks"), list):
        out["blocks"] = stack(out["blocks"])
    return out


def ulps(got, want) -> float:
    """max |got - want| in float32 ulps of the larger magnitude."""
    if got.size == 0:
        return 0.0
    g, w = got.astype(np.float64), want.astype(np.float64)
    ulp = np.spacing(np.maximum(np.abs(g), np.abs(w)).astype(np.float32))
    return float(np.max(np.abs(g - w) / np.maximum(
        ulp.astype(np.float64), np.finfo(np.float32).tiny)))


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def assert_tree_close(got, want, act):
    """``got`` the port's tree (blocks stacked), ``want`` the reference's:
    the same paths, dtypes and values within the dtype's tolerance (a
    bf16 leaf may sit a bf16 rounding from a float32 value)."""
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for path in w:
        a, b = g[path], w[path]
        if isinstance(a, int):
            assert a == int(b), path
            continue
        assert str(a.dtype) == f"torch.{b.dtype}", (path, a.dtype, b.dtype)
        if act == "float32":
            tol = dict(TOL, rtol=2.0 ** -7) if a.dtype == torch.bfloat16 \
                else TOL
            np.testing.assert_allclose(numpy(a), np.asarray(b, np.float32),
                                       err_msg=path, **tol)
        else:
            assert rel_err(numpy(a), b) <= BF16_REL, (path, rel_err(
                numpy(a), b))


def assert_logits_close(got, want, act):
    if act == "float32":
        np.testing.assert_allclose(numpy(got), np.asarray(want), **TOL)
    else:
        assert rel_err(numpy(got), want) <= BF16_REL, rel_err(numpy(got),
                                                              want)


def prompt_of(cfg, batch):
    """The serving prompt of a training batch: its embeddings for a model
    fed embeddings, else its tokens."""
    key = "embeds" if cfg.input_mode == "embeddings" else "tokens"
    return {key: batch[key]}


@functools.lru_cache(maxsize=None)
def reference_run(arch, act):
    """The reference on SMOKE ``arch`` from PRNGKey(0) and batch 0 of the
    LM stream: prefill (cache in float32 at float32 activations, so that
    the cache leaves and decode logits are held to TOL) and GEN decode
    steps fed its own greedy tokens, and forward_train's loss and
    gradients.  Leaves as numpy."""
    jc, _ = configs(arch, act)
    jp = jtr.init_params(jc, jax.random.PRNGKey(0))
    batch = lm_batch(jc, B, S, 0)
    cache_dtype = jnp.float32 if act == "float32" else jnp.bfloat16
    logits, cache = jax.jit(jtr.prefill, static_argnums=(0, 3, 4))(
        jc, jp, prompt_of(jc, batch), S + GEN, cache_dtype)
    tokens = [np.asarray(jnp.argmax(logits, -1)).astype(np.int32)[:, None]]
    caches = [jax.tree.map(np.asarray, cache)]
    decoded = []
    step = jax.jit(jtr.decode_step, static_argnums=0)
    for _ in range(GEN):
        d, cache = step(jc, jp, cache, jnp.asarray(tokens[-1]))
        decoded.append(np.asarray(d))
        caches.append(jax.tree.map(np.asarray, cache))
        tokens.append(np.asarray(jnp.argmax(d, -1)).astype(np.int32)[:, None])
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jtr.forward_train(jc, p, batch), has_aux=True))(jp)
    return dict(params=jax.tree.map(np.asarray, jp),
                batch={k: np.asarray(v) for k, v in batch.items()},
                prefill=np.asarray(logits), caches=caches, decoded=decoded,
                tokens=tokens, metrics={k: float(v)
                                        for k, v in metrics.items()},
                grads=[np.asarray(g, np.float32)
                       for g in jax.tree.leaves(grads)])


def port_params(arch, act, ref):
    """The reference's weights as the port's (blocks as a list)."""
    return lm_params_from_reference(ref["params"], configs(arch, act)[1],
                                    device="cpu")


def check_forward_train(arch, act):
    ref = reference_run(arch, act)
    _, tc = configs(arch, act)
    params = stacked(port_params(arch, act, ref))
    grads, metrics = grads_of(tc, params, {k: tensor(v) for k, v in
                                           ref["batch"].items()})
    got = [numpy(g) for g in tree_leaves(grads)]
    assert len(got) == len(ref["grads"])
    want_loss = ref["metrics"]["loss"]
    if act == "float32":
        np.testing.assert_allclose(float(metrics["loss"]), want_loss,
                                   **F32_TOL)
        np.testing.assert_allclose(float(metrics["moe_aux"]),
                                   ref["metrics"]["moe_aux"], **F32_TOL)
        for a, b in zip(got, ref["grads"], strict=True):
            np.testing.assert_allclose(a, b, **F32_TOL)
    else:
        np.testing.assert_allclose(float(metrics["loss"]), want_loss,
                                   rtol=BF16_LOSS_RTOL)
        for a, b in zip(got, ref["grads"], strict=True):
            assert np.linalg.norm(a - b) <= BF16_GRAD_NORM_REL * max(
                np.linalg.norm(b), 1e-30)
    assert float(metrics["tokens"]) == ref["metrics"]["tokens"]
    return metrics


def check_prefill_and_decode(arch, act):
    ref = reference_run(arch, act)
    _, tc = configs(arch, act)
    params = port_params(arch, act, ref)
    cache_dtype = torch.float32 if act == "float32" else torch.bfloat16
    prompt = {k: tensor(v) for k, v in prompt_of(tc, ref["batch"]).items()}
    logits, cache = ttr.prefill(tc, params, prompt, max_len=S + GEN,
                                cache_dtype=cache_dtype)
    assert_logits_close(logits, ref["prefill"], act)
    assert_tree_close(stacked(cache), ref["caches"][0], act)
    for i in range(GEN):
        d, cache = ttr.decode_step(tc, params, cache,
                                   torch.from_numpy(ref["tokens"][i]))
        assert_logits_close(d, ref["decoded"][i], act)
        assert_tree_close(stacked(cache), ref["caches"][i + 1], act)
    assert cache["pos"] == S + GEN


def check_generate(arch):
    """generate's greedy tokens at float32 activations against the
    reference's ``launch/serve.generate`` (bf16 caches in both)."""
    ref = reference_run(arch, "float32")
    jc, tc = configs(arch, "float32")
    jp = jax.tree.map(jnp.asarray, ref["params"])
    want, _ = jserve.generate(jc, jp, {k: jnp.asarray(v) for k, v in
                                       prompt_of(jc, ref["batch"]).items()},
                              GEN + 1)
    got, _ = tserve.generate(tc, port_params(arch, "float32", ref),
                             {k: tensor(v) for k, v in
                              prompt_of(tc, ref["batch"]).items()},
                             GEN + 1, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def check_train_step(arch, act="float32"):
    """One make_train_step with get_optimizer(cfg): the loss and every
    updated parameter and optimizer-state leaf.  At bfloat16 activations
    the state's moments follow the gradients (BF16_GRAD_NORM_REL of each
    leaf's norm, twice that for the squared moments) and a parameter
    moves by at most lr in either package's first AdamW step, so the two
    agree within BF16_STEP_ATOL."""
    ref = reference_run(arch, act)
    jc, tc = configs(arch, act)
    jp = jax.tree.map(jnp.asarray, ref["params"])
    jopt = jget_optimizer(jc)
    jparams, jstate, jm = jax.jit(jmake_train_step(jc, jopt))(
        jp, jopt.init(jp), jax.tree.map(jnp.asarray, ref["batch"]))
    opt = get_optimizer(tc)
    assert opt.name == jopt.name
    params = stacked(port_params(arch, act, ref))
    params, state, metrics = make_train_step(tc, opt)(
        params, opt.init(params), {k: tensor(v) for k, v in
                                   ref["batch"].items()})
    pairs = [(tree_leaves(params), jax.tree.leaves(jparams)),
             (tree_leaves(state), jax.tree.leaves(jstate))]
    assert all(len(g) == len(w) for g, w in pairs)
    if act == "float32":
        np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                                   **F32_TOL)
        for (g, w), tol in zip(pairs, (STEP_TOL, F32_TOL), strict=True):
            for a, b in zip(g, w, strict=True):
                np.testing.assert_allclose(numpy(a), np.asarray(
                    b, np.float32), **tol)
        return opt
    assert opt.name == "adamw"
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               rtol=BF16_LOSS_RTOL)
    for a, b in zip(*pairs[0], strict=True):
        np.testing.assert_allclose(numpy(a), np.asarray(b, np.float32),
                                   rtol=0, atol=BF16_STEP_ATOL)
    for a, b in zip(*pairs[1], strict=True):
        b = np.asarray(b, np.float32)
        assert np.linalg.norm(numpy(a) - b) <= 2 * BF16_GRAD_NORM_REL * max(
            np.linalg.norm(b), 1e-30)
    return opt


# ---------------------------------------------------------------------------
# the registry and the configs
# ---------------------------------------------------------------------------
def test_registry_lists_the_references_ten_in_order():
    assert list(ARCHS) == list(JARCHS)
    assert len(ARCHS) == 10


@pytest.mark.parametrize("size", ["FULL", "SMOKE"])
@pytest.mark.parametrize("arch", list(JARCHS))
def test_configs_equal_the_references_field_by_field(arch, size):
    want = getattr(JARCHS[arch], size)
    got = getattr(ARCHS[arch], size)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert got.layer_kinds() == want.layer_kinds()
    assert ttr.block_layout(got) == jtr.block_layout(want)


@pytest.mark.parametrize("arch", list(JARCHS))
def test_init_params_is_the_references_within_ulps(arch):
    """Every leaf within ULPS float32 ulp of ``jax.jit(init_params)``,
    names, shapes and dtypes exactly; the count is the config's.  RWKV's
    ``w0`` is a linspace that XLA compiles with fused multiply-adds
    (``models/rglru.py::linspace``): it agrees to two ulp of its
    endpoint 1.5, not of each point."""
    jc, tc = JARCHS[arch].SMOKE, ARCHS[arch].SMOKE
    want = flat(jax.jit(lambda k: jtr.init_params(jc, k))(
        jax.random.PRNGKey(0)))
    got_tree = ttr.init_params(tc, prng.PRNGKey(0), device="cpu")
    got = flat(stacked(got_tree))
    assert sorted(got) == sorted(want)
    for path in want:
        a, b = numpy(got[path]), np.asarray(want[path], np.float32)
        assert a.shape == b.shape, path
        assert str(got[path].dtype) == f"torch.{want[path].dtype}", path
        if path.endswith("/w0"):
            assert np.abs(a - b).max() <= 2 * np.spacing(np.float32(1.5))
        else:
            assert ulps(a, b) <= ULPS, (path, ulps(a, b))
    assert sum(t.numel() for t in tree_leaves(got_tree)) == \
        sum(np.size(t) for t in want.values())


# ---------------------------------------------------------------------------
# the dense six: serving and training against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("arch", DENSE)
def test_forward_train_matches_the_reference(arch, act):
    check_forward_train(arch, act)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_cache_and_decode_match_the_reference(arch, act):
    check_prefill_and_decode(arch, act)


@pytest.mark.parametrize("arch", DENSE)
def test_generate_tokens_equal_the_references(arch):
    check_generate(arch)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("arch", DENSE)
def test_one_train_step_matches_the_reference(arch, act):
    check_train_step(arch, act)
