"""The port's RG-LRU against the JAX package's: the plain scan
(kernels/rglru/ref.py) against the JAX oracle ``rglru_scan_ref`` and the
model's ``_scan_linear`` (associative scan), the wrapper's CPU path, and
``rglru_block`` / ``rglru_decode`` on weights carried across.  The Pallas
kernel is not a reference here: it does not run on the installed jax
(ROADMAP C).  The CUDA kernel is held against the plain version on the
card in tests/test_torch_cuda_lm.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import recurrentgemma_2b as jconfigs  # noqa: E402
from repro.kernels.rglru.ref import rglru_scan_ref as j_ref  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch.api.convert import _tree  # noqa: E402
from repro_torch.configs import recurrentgemma_2b as tconfigs  # noqa: E402
from repro_torch.kernels.rglru import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.rglru.ops import rglru_scan  # noqa: E402
from repro_torch.kernels.rglru.ref import rglru_scan_ref as t_ref  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402

torch.set_num_threads(1)

# float32 in both; the sequential scans differ only where XLA contracts
# a*h + b into one rounding, the associative scan in its order of products
TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 activations: jax rounds inside silu/gelu/softplus/sigmoid op by op,
# torch once per op, so single values differ by an ulp of bf16 (2^-8)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def _inputs(B, S, W, decay=0.9, seed=0):
    rng = np.random.default_rng(seed)
    a = (decay + (1 - decay) * rng.uniform(size=(B, S, W))).astype(
        np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("B,S,W", [(1, 1, 8), (1, 32, 128), (2, 256, 128),
                                   (2, 384, 64), (3, 37, 40)])
def test_ref_matches_jax_ref(B, S, W):
    a, b, h0 = _inputs(B, S, W)
    jh, jl = j_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    th, tl = t_ref(*map(torch.from_numpy, (a, b, h0)))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_long_sequence_matches_jax_ref():
    """4k steps with realistic decays: no drift against the oracle."""
    a, b, h0 = _inputs(1, 4096, 32, decay=0.99, seed=1)
    _, jl = j_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    _, tl = t_ref(*map(torch.from_numpy, (a, b, h0)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("B,S,W", [(2, 128, 128), (1, 300, 16)])
def test_op_matches_model_associative_scan(B, S, W):
    """The op the port's model calls (h0 = 0) against the reference
    model's ``_scan_linear``."""
    a, b, _ = _inputs(B, S, W, seed=2)
    want = np.asarray(jax.jit(jrglru._scan_linear)(jnp.asarray(a),
                                                  jnp.asarray(b)))
    before = t_kernel.LAUNCHES
    h, h_last = rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert t_kernel.LAUNCHES == before   # no kernel on CPU tensors
    np.testing.assert_allclose(h.numpy(), want, **TOL)
    assert torch.equal(h_last, h[:, -1])
    np.testing.assert_allclose(
        trglru.linear_recurrence(torch.from_numpy(a), torch.from_numpy(b),
                                 plain=True).numpy(), want, **TOL)


def test_empty_sequence_returns_h0():
    a = torch.zeros(2, 0, 4)
    h0 = torch.arange(8.0).reshape(2, 4)
    h, h_last = rglru_scan(a, a, h0)
    assert h.shape == (2, 0, 4) and torch.equal(h_last, h0)


@pytest.fixture(scope="module")
def block_params():
    cfg = jconfigs.SMOKE
    jp = jrglru.init_rglru_params(jax.random.PRNGKey(3), cfg, jnp.float32)
    return jp, _tree(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_matches_jax(block_params, dtype):
    jp, tp = block_params
    jdt, tdt = jcommon.dtype_of(dtype), tcommon.dtype_of(dtype)
    x = (0.5 * np.random.default_rng(4).standard_normal(
        (2, 24, jconfigs.SMOKE.d_model))).astype(np.float32)
    tx = torch.from_numpy(x).to(tdt)
    jx = jnp.asarray(tx.float().numpy()).astype(jdt)
    want = jax.jit(jrglru.rglru_block, static_argnums=1)(
        jcommon.cast_floats(jp, jdt), jconfigs.SMOKE, jx)
    got = trglru.rglru_block(tcommon.cast_floats(tp, tdt), tconfigs.SMOKE,
                             tx)
    assert got.dtype == tdt
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_jax(block_params, dtype):
    """Three O(1) steps from a non-zero state: outputs and both cache
    leaves."""
    jp, tp = block_params
    cfg = jconfigs.SMOKE
    jdt, tdt = jcommon.dtype_of(dtype), tcommon.dtype_of(dtype)
    rng = np.random.default_rng(5)
    W = cfg.lru_width
    h = rng.standard_normal((2, W)).astype(np.float32)
    conv = torch.from_numpy(rng.standard_normal(
        (2, cfg.conv_width - 1, W)).astype(np.float32)).to(tdt)
    jcache = {"h": jnp.asarray(h),
              "conv": jnp.asarray(conv.float().numpy()).astype(jdt)}
    tcache = {"h": torch.from_numpy(h), "conv": conv}
    jpc = jcommon.cast_floats(jp, jdt)
    tpc = tcommon.cast_floats(tp, tdt)
    tol = TOL if dtype == "float32" else BF16_TOL
    for step in range(3):
        x = torch.from_numpy((0.5 * rng.standard_normal(
            (2, 1, cfg.d_model))).astype(np.float32)).to(tdt)
        jo, jcache = jax.jit(jrglru.rglru_decode, static_argnums=1)(
            jpc, cfg, jnp.asarray(x.float().numpy()).astype(jdt), jcache)
        to, tcache = trglru.rglru_decode(tpc, tconfigs.SMOKE, x, tcache)
        np.testing.assert_allclose(to.float().numpy(),
                                   np.asarray(jo, np.float32), **tol)
        for leaf in ("h", "conv"):
            assert tcache[leaf].dtype == tcommon.dtype_of(
                str(jcache[leaf].dtype))
            np.testing.assert_allclose(
                tcache[leaf].float().numpy(),
                np.asarray(jcache[leaf], np.float32), **tol)
