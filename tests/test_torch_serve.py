"""The port's serving path -- models/{common,attention,rglru,transformer}
and launch/serve.generate -- against the JAX package's on the
recurrentgemma-2b SMOKE config, with the reference's weights carried
across by ``api.convert.lm_params_from_reference``; the port's own
prefill -> decode consistency; its entry points; and that no module of
the port loads jax or the JAX package."""
import dataclasses
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import recurrentgemma_2b as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.api.convert import lm_params_from_reference  # noqa: E402
from repro_torch.configs import recurrentgemma_2b as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMPLS = ["xla_chunked", "flash"]
# float32 activations: the same arithmetic in two libraries, summed in
# other orders (observed max |diff| ~5e-7 on logits of size ~0.5)
TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 activations: jax rounds inside silu/gelu/softplus/sigmoid op by op,
# torch once per op; single values differ by an ulp of bf16 (2^-8) and the
# differences ride through the layers (observed max 0.008 on logits ~0.46)
BF16_LOGITS_ATOL = 0.04


def _cfgs(act="float32", impl="xla_chunked"):
    return (dataclasses.replace(jconfigs.SMOKE, activation_dtype=act,
                                attention_impl=impl),
            dataclasses.replace(tconfigs.SMOKE, activation_dtype=act,
                                attention_impl=impl))


@pytest.fixture(scope="module")
def params():
    jp = jtr.init_params(jconfigs.SMOKE, jax.random.PRNGKey(0))
    return jp, lm_params_from_reference(jax.tree.map(np.asarray, jp),
                                        tconfigs.SMOKE, device="cpu")


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, jconfigs.SMOKE.vocab_size, (B, S)).astype(np.int32)


def _stack(trees):
    """The port's list of per-block trees as one tree of stacked leaves."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _assert_tree_close(got, want, **tol):
    """``got`` is the port's tree (blocks as a list), ``want`` the
    reference's (blocks stacked on a leading axis)."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            g = got[k]
            if k == "blocks":
                g = _stack(g)
            _assert_tree_close(g, want[k], **tol)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want, strict=True):
            _assert_tree_close(g, w, **tol)
    elif isinstance(got, int):
        assert got == int(want)
    else:
        assert str(got.dtype) == f"torch.{want.dtype}"
        if got.dtype == torch.bfloat16:
            # float32 values a rounding apart may land one bf16 ulp apart
            tol = dict(tol, rtol=2.0 ** -7)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_jax(dtype):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 8, 4, 16)).astype(
        np.float32)).to(tcommon.dtype_of(dtype))
    jx = jnp.asarray(x.float().numpy()).astype(jcommon.dtype_of(dtype))
    scale = (0.1 * rng.standard_normal(16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(100, 108, dtype=np.int32), (2, 8))
    tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    for got, want in [
        (tcommon.rms_norm(x, torch.from_numpy(scale)),
         jcommon.rms_norm(jx, jnp.asarray(scale))),
        (tcommon.rope(x, torch.from_numpy(pos.copy()), 10_000.0),
         jcommon.rope(jx, jnp.asarray(pos), 10_000.0)),
    ]:
        assert got.dtype == x.dtype
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_paths_match_jax(params, impl, dtype):
    """One attention layer over 64 positions (window 16): the plain chunked
    path and the flash path (Pallas in interpret mode on the reference
    side, the kernel's plain version on the port's)."""
    jp, tp = params
    jcfg, tcfg = _cfgs(dtype, impl)
    jdt, tdt = jcommon.dtype_of(dtype), tcommon.dtype_of(dtype)
    jmix = jcommon.cast_floats(
        jax.tree.map(lambda t: t[0], jp["blocks"])["sub2"]["mix"], jdt)
    tmix = tcommon.cast_floats(tp["blocks"][0]["sub2"]["mix"], tdt)
    x = torch.from_numpy((0.5 * np.random.default_rng(2).standard_normal(
        (2, 64, jcfg.d_model))).astype(np.float32)).to(tdt)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64))
    want = jattn.attend(jmix, jcfg, jnp.asarray(x.float().numpy()).astype(
        jdt), jnp.asarray(pos))
    got = tattn.attend(tmix, tcfg, x, torch.from_numpy(pos.copy()))
    tol = TOL if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_decode_attention_past_the_window_matches_jax(params):
    """A 40-token prompt (window 16, so the ring buffer has wrapped) laid
    into the cache, then three decode steps: outputs and cache leaves."""
    jp, tp = params
    jcfg, tcfg = _cfgs()
    jsub = jax.tree.map(lambda t: t[0], jp["blocks"])["sub2"]
    tsub = tp["blocks"][0]["sub2"]
    rng = np.random.default_rng(3)
    h = (0.5 * rng.standard_normal((2, 40, jcfg.d_model))).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    jcache = jtr._attn_prefill_cache(jsub, jcfg, jnp.asarray(h),
                                     jnp.asarray(pos), 64, jnp.bfloat16)
    tcache = ttr._attn_prefill_cache(tsub, tcfg, torch.from_numpy(h),
                                     torch.from_numpy(pos.copy()), 64,
                                     torch.bfloat16)
    _assert_tree_close(tcache, jcache, **TOL)
    for p in (40, 41, 42):
        x = (0.5 * rng.standard_normal((2, 1, jcfg.d_model))).astype(
            np.float32)
        jo, jcache = jax.jit(jattn.decode_attention, static_argnums=1)(
            jsub["mix"], jcfg, jnp.asarray(x), jnp.int32(p), jcache)
        to, tcache = tattn.decode_attention(tsub["mix"], tcfg,
                                            torch.from_numpy(x), p, tcache)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        _assert_tree_close(tcache, jcache, **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_logits_and_every_cache_leaf_match_jax(params, impl):
    jp, tp = params
    jcfg, tcfg = _cfgs("float32", impl)
    toks = _tokens(2, 32)
    jl, jcache = jax.jit(jtr.prefill, static_argnums=(0, 3))(
        jcfg, jp, {"tokens": jnp.asarray(toks)}, 48)
    tl, tcache = ttr.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                             max_len=48)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_tree_close(tcache, jcache, **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_generate_tokens_equal_jax_in_float32(params, impl):
    jp, tp = params
    jcfg, tcfg = _cfgs("float32", impl)
    toks = _tokens(2, 24, seed=4)
    jout, _ = jserve.generate(jcfg, jp, {"tokens": jnp.asarray(toks)}, 10)
    tout, stats = tserve.generate(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                                  10, device="cpu")
    assert tout.dtype == torch.int32 and tout.shape == (2, 10)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert set(stats) == {"prefill_s", "decode_s", "tok_per_s"}


@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_prefill_and_decode_logits_within_tolerance(params, impl):
    """The default activation dtype: prefill logits and the first decode
    step's logits within BF16_LOGITS_ATOL of the reference's."""
    jp, tp = params
    jcfg, tcfg = _cfgs("bfloat16", impl)
    toks = _tokens(2, 32, seed=5)
    jl, jcache = jax.jit(jtr.prefill, static_argnums=(0, 3))(
        jcfg, jp, {"tokens": jnp.asarray(toks)}, 40)
    tl, tcache = ttr.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                             max_len=40)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=BF16_LOGITS_ATOL)
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    jd, _ = jtr.decode_step(jcfg, jp, jcache, jnp.asarray(nxt))
    td, _ = ttr.decode_step(tcfg, tp, tcache, torch.from_numpy(nxt))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=BF16_LOGITS_ATOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_then_decode_equals_a_longer_prefill(params, impl):
    """The port's own contract: prefill of S tokens then decode steps give
    the logits a prefill of the longer prompt gives at its last position
    (S = 20 > window 16, so the ring buffer wraps while decoding)."""
    _, tp = params
    _, tcfg = _cfgs("float32", impl)
    toks = torch.from_numpy(_tokens(2, 23, seed=6))
    _, cache = ttr.prefill(tcfg, tp, {"tokens": toks[:, :20]}, max_len=23,
                           cache_dtype=torch.float32)
    for t in range(20, 23):
        logits, cache = ttr.decode_step(tcfg, tp, cache, toks[:, t: t + 1])
        want, _ = ttr.prefill(tcfg, tp, {"tokens": toks[:, : t + 1]})
        np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5)
    assert cache["pos"] == 23


def test_init_params_has_the_reference_layout_and_count(params):
    jp, _ = params
    cfg = tconfigs.SMOKE
    tp = ttr.init_params(cfg, 0, device="cpu")
    ref = jax.tree.map(lambda t: np.zeros(t.shape, t.dtype), jp)
    _assert_tree_close(jax.tree.map(torch.zeros_like, tp), ref)
    assert sum(t.numel() for t in jax.tree.leaves(tp)) == cfg.param_count()


def test_unported_kinds_raise_naming_the_roadmap():
    """The kinds once refused here (RWKV6 and MoE FFNs, ROADMAP A9.3 and
    A9.4) now run: recurrentgemma SMOKE made attention-free RWKV, and
    with 4 experts of top 2, inits and generates in range; only an
    unknown sub-layer kind raises."""
    moe = dataclasses.replace(tconfigs.SMOKE, num_experts=4,
                              experts_per_token=2)
    rwkv = dataclasses.replace(tconfigs.SMOKE, is_rwkv=True)
    for cfg in (rwkv, moe):
        params = ttr.init_params(cfg, 0, device="cpu")
        out, _ = tserve.generate(cfg, params,
                                 {"tokens": torch.from_numpy(_tokens(2, 16))},
                                 3, device="cpu")
        assert out.shape == (2, 3)
        assert bool(((out >= 0) & (out < cfg.vocab_size)).all())
        assert ("ffn" in params["blocks"][0]["sub0"]) == cfg.is_moe
    assert ttr.block_layout(rwkv)[0] == ("rwkv",)
    with pytest.raises(ValueError, match="unknown sub-layer kind"):
        ttr.init_cache(dataclasses.replace(tconfigs.SMOKE,
                                           block_pattern=("conv",)),
                       1, 8, device="cpu")


def test_entry_points_default_to_the_card(capsys):
    sig = inspect.signature(tserve.generate)
    assert sig.parameters["device"].default == "cuda"
    tserve.main(["--arch", "recurrentgemma-2b", "--smoke", "--batch", "2",
                 "--prompt-len", "8", "--gen", "3", "--device", "cpu"])
    assert "generated: (2, 3)" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tserve.main(["--arch", "recurrentgemma-2b", "--smoke"])


def test_port_imports_no_jax_and_no_reference_module():
    """Import every module of repro_torch in a fresh interpreter; none of
    them may load jax, jaxlib or the JAX package ``repro``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(names), bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) > 30 and bad == "[]"
