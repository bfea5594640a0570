"""The port's RWKV-6 (models/rwkv6.py and the ``rwkv`` kind of
models/transformer.py) against the JAX package's: the chunked WKV and its
terminal state, the time and channel mixes and their decode pair on the
same weights and inputs, the chunk-length check (a ValueError where the
reference asserts, and in the prefill, where the reference has no check),
the port's own prefill -> decode contract, and rwkv6-smoke through
forward_train, one train step, prefill, decode and generate, with the
reference's weights and optimizer state carried across by ``api.convert``.

Tolerances: WKV_TOL for the chunked WKV in float32 (the within-chunk
cumulative sums and the chunk products add in other orders, and
exp(-lw) scales terms by up to e^64, so the error is taken relative to
each output's largest magnitude); the mixes at float32 to TOL, at
bfloat16 to BF16_REL of their largest magnitude (torch rounds silu,
sigmoid and tanh once, jax op by op); whole-model tolerances are
tests/test_torch_arch.py's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import common as jcommon  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.optim import get_optimizer as jget_optimizer  # noqa: E402
from repro_torch.api.convert import (lm_params_from_reference,  # noqa: E402
                                     lm_state_from_reference)
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.optim.api import tree_leaves  # noqa: E402
from test_torch_arch import (ACTS, BF16_REL, TOL,  # noqa: E402
                             check_forward_train, check_generate,
                             check_prefill_and_decode, check_train_step,
                             configs, flat, numpy, rel_err, stacked, tensor)

torch.set_num_threads(1)

ARCH = "rwkv6-1.6b"
WKV_TOL = 1e-5


def _wkv_inputs(S, B=2, H=3, N=16, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, S, N)).astype(np.float32)
               for _ in range(3))
    log_w = rng.uniform(trwkv.LOG_W_MIN, trwkv.LOG_W_MAX,
                        (B, H, S, N)).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, N))).astype(np.float32)
    return r, k, v, log_w, u


def _assert_rel(got, want, tol):
    assert rel_err(numpy(got), np.asarray(want, np.float32)) <= tol


@pytest.mark.parametrize("S", [5, 16, 64])
def test_wkv_chunked_and_its_terminal_state_match_the_reference(S):
    """S = 5 is one short chunk, 16 one whole chunk, 64 four."""
    ins = _wkv_inputs(S)
    want = jrwkv._wkv_chunked(*map(jnp.asarray, ins))
    want_y, want_state = jtr._wkv_chunked_with_state(*map(jnp.asarray, ins))
    got_y, got_state = trwkv.wkv_chunked_with_state(
        *map(torch.from_numpy, ins))
    _assert_rel(got_y, want, WKV_TOL)
    _assert_rel(got_y, want_y, WKV_TOL)
    _assert_rel(got_state, want_state, WKV_TOL)
    assert torch.equal(trwkv._wkv_chunked(*map(torch.from_numpy, ins)),
                       got_y)


def test_chunk_length_is_checked_where_the_reference_asserts_and_more():
    """S = 20 is neither one short chunk nor a multiple of 16: the
    reference's _wkv_chunked asserts and its prefill's copy fails in a
    reshape; the port raises a ValueError in both."""
    ins = _wkv_inputs(20)
    with pytest.raises(AssertionError):
        jrwkv._wkv_chunked(*map(jnp.asarray, ins))
    with pytest.raises(TypeError):
        jtr._wkv_chunked_with_state(*map(jnp.asarray, ins))
    with pytest.raises(ValueError, match="multiple of 16"):
        trwkv._wkv_chunked(*map(torch.from_numpy, ins))
    _, tc = configs(ARCH)
    params = ttr.init_params(tc, 0, device="cpu")
    with pytest.raises(ValueError, match="multiple of 16"):
        ttr.prefill(tc, params, {"tokens": torch.zeros((1, 20),
                                                       dtype=torch.int32)})


def _mix(act, S=32, seed=0):
    """Block 0's mixer weights cast to ``act`` and inputs for both."""
    jc, tc = configs(ARCH, act)
    jp = jtr.init_params(jc, jax.random.PRNGKey(seed))
    mix = jax.tree.map(lambda t: t[0], jp["blocks"])["sub0"]["mix"]
    jmix = jcommon.cast_floats(mix, jcommon.dtype_of(act))
    tmix = jax.tree.map(lambda a: tensor(np.asarray(a)), jmix)
    x = (0.5 * np.random.default_rng(seed + 1).standard_normal(
        (2, S, jc.d_model))).astype(np.float32)
    jx = jnp.asarray(x).astype(jcommon.dtype_of(act))
    return jc, tc, jmix, tmix, jx, tensor(np.asarray(jx))


def _assert_mix_close(got, want, act):
    if act == "float32":
        np.testing.assert_allclose(numpy(got), np.asarray(want), **TOL)
    else:
        _assert_rel(got, want, BF16_REL)


@pytest.mark.parametrize("act", ACTS)
def test_time_and_channel_mix_match_the_reference(act):
    jc, tc, jp, tp, jx, tx = _mix(act)
    for jf, tf in ((jrwkv.time_mix, trwkv.time_mix),
                   (jrwkv.channel_mix, trwkv.channel_mix)):
        got, want = tf(tp, tc, tx), jf(jp, jc, jx)
        assert got.dtype == tx.dtype
        _assert_mix_close(got, want, act)


@pytest.mark.parametrize("act", ACTS)
def test_decode_pair_matches_the_reference(act):
    """time_mix_decode then channel_mix_decode from a random cache: the
    outputs and every cache leaf (the WKV state float32, the shifts in
    the activation dtype)."""
    jc, tc, jp, tp, jx, tx = _mix(act, S=1)
    rng = np.random.default_rng(7)
    jcache = jrwkv.init_rwkv_cache(jc, 2, dtype=jcommon.dtype_of(act))
    jcache = {k: jnp.asarray(rng.standard_normal(v.shape).astype(
        np.float32)).astype(v.dtype) for k, v in jcache.items()}
    tcache = {k: tensor(np.asarray(v)) for k, v in jcache.items()}
    empty = trwkv.init_rwkv_cache(tc, 2, dtype=tx.dtype, device="cpu")
    assert {k: (v.dtype, tuple(v.shape)) for k, v in empty.items()} == {
        k: (v.dtype, tuple(v.shape)) for k, v in tcache.items()}
    for jf, tf in ((jrwkv.time_mix_decode, trwkv.time_mix_decode),
                   (jrwkv.channel_mix_decode, trwkv.channel_mix_decode)):
        want, jcache = jf(jp, jc, jx, jcache)
        got, tcache = tf(tp, tc, tx, tcache)
        _assert_mix_close(got, want, act)
        for k in jcache:
            assert str(tcache[k].dtype) == f"torch.{jcache[k].dtype}"
            _assert_mix_close(tcache[k], jcache[k], act)


def test_prefill_then_decode_equals_a_longer_prefill():
    """The port's own contract at float32 activations and cache: an
    8-token prefill then 8 and 24 teacher-forced decode steps give the
    last logits of 16- and 32-token prefills."""
    _, tc = configs(ARCH, "float32")
    params = ttr.init_params(tc, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tc.vocab_size, (2, 32)).astype(np.int32))
    _, cache = ttr.prefill(tc, params, {"tokens": toks[:, :8]},
                           cache_dtype=torch.float32)
    for t in range(8, 32):
        logits, cache = ttr.decode_step(tc, params, cache, toks[:, t: t + 1])
        if t + 1 in (16, 32):
            want, _ = ttr.prefill(tc, params, {"tokens": toks[:, : t + 1]})
            np.testing.assert_allclose(logits.numpy(), want.numpy(),
                                       rtol=1e-4, atol=1e-5)
    assert cache["pos"] == 32


@pytest.mark.parametrize("act", ACTS)
def test_forward_train_matches_the_reference(act):
    check_forward_train(ARCH, act)


@pytest.mark.parametrize("act", ACTS)
def test_prefill_cache_and_decode_match_the_reference(act):
    check_prefill_and_decode(ARCH, act)


def test_generate_tokens_equal_the_references():
    check_generate(ARCH)


@pytest.mark.parametrize("act", ACTS)
def test_one_train_step_matches_the_reference(act):
    assert check_train_step(ARCH, act).name == "adamw"


def test_rwkv_layers_have_no_ffn_and_every_leaf_a_gradient():
    """An rwkv sub-layer keeps its channel mix in ``mix`` (ln2 but no
    ``ffn``), and every one of its leaves gets a nonzero gradient."""
    from repro_torch.launch.steps import grads_of
    _, tc = configs(ARCH)
    params = stacked(ttr.init_params(tc, prng.PRNGKey(0), device="cpu"))
    assert set(params["blocks"]["sub0"]) == {"ln1", "mix", "ln2"}
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.int32),
             "labels": torch.ones((2, 16), dtype=torch.int32)}
    grads, _ = grads_of(tc, params, batch)
    for path, g in flat(grads["blocks"]).items():
        assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0, \
            path


def test_convert_carries_rwkv_params_and_state():
    jc, tc = configs(ARCH)
    jp = jax.tree.map(np.asarray, jtr.init_params(jc,
                                                  jax.random.PRNGKey(1)))
    got = lm_params_from_reference(jp, tc, device="cpu")
    g, w = flat(stacked(got)), flat(jp)
    assert sorted(g) == sorted(w)
    for path in w:
        np.testing.assert_array_equal(numpy(g[path]), w[path])
    opt = jax.tree.map(np.asarray, jget_optimizer(jc).init(
        jax.tree.map(jnp.asarray, jp)))
    two = lambda t: np.stack([np.asarray(t), 2 * np.asarray(t)])  # noqa: E731
    state = {"params": jax.tree.map(two, jp),
             "opt_state": jax.tree.map(two, opt), "step": np.int32(5),
             "residual": jax.tree.map(two, jp)}
    st = lm_state_from_reference(state, replica=1, device="cpu")
    assert st.step == 5
    for a, b in zip(tree_leaves(st.residual), jax.tree.leaves(jp),
                    strict=True):
        np.testing.assert_array_equal(numpy(a), 2 * b)
    assert len(tree_leaves(st.opt_state)) == len(jax.tree.leaves(opt))
