"""The port's blocked-SDCA leaf solve against the JAX package's: the plain
version (kernels/sdca/ref.py) against the JAX oracle and the Pallas kernel
in interpret mode, the wrapper's CPU path, one CoCoA round (ops.py) and
the single-leaf oracle (core/local_sdca.py).  The CUDA kernel itself is
held against the plain version on the card in tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import dual as jdual  # noqa: E402
from repro.core.local_sdca import local_sdca as j_local_sdca  # noqa: E402
from repro.kernels.sdca.kernel import sdca_block_kernel as j_kernel  # noqa: E402
from repro.kernels.sdca.ops import sdca_block_solve as j_solve  # noqa: E402
from repro.kernels.sdca.ref import sdca_block_ref as j_ref  # noqa: E402
from repro_torch.core import dual as tdual  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.local_sdca import local_sdca as t_local_sdca  # noqa: E402
from repro_torch.kernels.sdca import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.sdca.ops import sdca_block_solve as t_solve  # noqa: E402
from repro_torch.kernels.sdca.ref import sdca_block_ref as t_ref  # noqa: E402
from test_torch_dual import jloss  # noqa: E402

torch.set_num_threads(1)

LOSSES = ["squared", "smooth_hinge_1", "hinge", "logistic"]
SHAPES = [(2, 32, 16, 64), (4, 64, 8, 128), (1, 128, 32, 256)]
# H sequential float32 steps in two libraries: <w, x_i> is summed in
# different orders, and the differences ride along the chain
TOL = dict(rtol=1e-4, atol=1e-5)


def _block(loss_name, K, m_b, d, H, seed=0, per_leaf=False, masked=False):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((K, m_b, d)).astype(np.float32)
    if loss_name == "squared":
        y = rng.standard_normal((K, m_b)).astype(np.float32)
        alpha = (0.1 * rng.standard_normal((K, m_b))).astype(np.float32)
    else:
        y = np.where(rng.standard_normal((K, m_b)) >= 0, 1.0, -1.0).astype(
            np.float32)
        alpha = (0.1 * np.abs(rng.standard_normal((K, m_b))) * y).astype(
            np.float32)
    w_shape = (K, d) if per_leaf else (d,)
    w = (0.1 * rng.standard_normal(w_shape)).astype(np.float32)
    idx = rng.integers(0, m_b, (K, H)).astype(np.int32)
    mask = (rng.uniform(size=(K, H)) < 0.7).astype(np.float32) \
        if masked else None
    return X, y, alpha, w, idx, mask


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("loss_name", LOSSES)
@pytest.mark.parametrize("K,m_b,d,H", SHAPES)
def test_ref_matches_jax_ref_and_pallas_kernel(loss_name, K, m_b, d, H):
    """The shapes of tests/test_kernels.py, all four losses (the JAX test
    leaves logistic out)."""
    X, y, alpha, w, idx, _ = _block(loss_name, K, m_b, d, H)
    lm = 0.1 * K * m_b
    da, dw = t_ref(*_torch(X, y, alpha, w, idx), loss=tdual.get_loss(
        loss_name), lm=lm)
    lj = jloss(loss_name)
    da_r, dw_r = j_ref(X, y, alpha, w, idx, loss=lj, lm=lm)
    da_k, dw_k = j_kernel(X, y, alpha, w, idx, loss=lj, lm=lm,
                          interpret=True)
    for want_a, want_w in ((da_r, dw_r), (da_k, dw_k)):
        np.testing.assert_allclose(da.numpy(), np.asarray(want_a), **TOL)
        np.testing.assert_allclose(dw.numpy(), np.asarray(want_w), **TOL)


@pytest.mark.parametrize("loss_name", LOSSES)
def test_ref_per_leaf_w_and_step_mask_match_jax(loss_name):
    X, y, alpha, w, idx, mask = _block(loss_name, 3, 48, 12, 96, seed=1,
                                       per_leaf=True, masked=True)
    lm = 0.05 * 3 * 48
    da, dw = t_ref(*_torch(X, y, alpha, w, idx), loss=tdual.get_loss(
        loss_name), lm=lm, step_mask=torch.from_numpy(mask))
    da_k, dw_k = j_kernel(X, y, alpha, w, idx, loss=jloss(loss_name),
                          lm=lm, step_mask=mask, interpret=True)
    np.testing.assert_allclose(da.numpy(), np.asarray(da_k), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_k), **TOL)


def test_all_ones_step_mask_is_bit_identical_to_no_mask():
    X, y, alpha, w, idx, _ = _block("squared", 2, 32, 8, 64, seed=2)
    args = _torch(X, y, alpha, w, idx)
    loss = tdual.squared
    a0, w0 = t_ref(*args, loss=loss, lm=6.4)
    a1, w1 = t_ref(*args, loss=loss, lm=6.4, step_mask=torch.ones(2, 64))
    assert torch.equal(a0, a1) and torch.equal(w0, w1)


def test_wrapper_takes_the_plain_version_on_cpu_tensors():
    X, y, alpha, w, idx, mask = _block("hinge", 2, 32, 8, 64, seed=3,
                                       per_leaf=True, masked=True)
    args = _torch(X, y, alpha, w, idx)
    before = t_kernel.LAUNCHES
    got = t_kernel.sdca_block_kernel(*args, loss=tdual.hinge, lm=6.4,
                                     step_mask=torch.from_numpy(mask))
    want = t_ref(*args, loss=tdual.hinge, lm=6.4,
                 step_mask=torch.from_numpy(mask))
    assert t_kernel.LAUNCHES == before          # no kernel ran
    assert all(torch.equal(g, r) for g, r in zip(got, want, strict=True))


def test_wrapper_names_losses_the_kernel_has_no_closed_form_for():
    custom = tdual.Loss("custom", tdual.squared.value, tdual.squared.conj_neg,
                        tdual.squared.coord_delta, gamma=1.0)
    with pytest.raises(NotImplementedError):
        t_kernel.loss_id(custom)
    assert [t_kernel.loss_id(tdual.get_loss(n)) for n in LOSSES] == \
        [0, 2, 1, 3]


def test_a_custom_loss_with_cuda_source_builds_its_own_library():
    """A ``kind ""`` loss with its step in CUDA C++ is the kernel's code 4,
    and ``sdca_block.cu`` is built after a prelude that defines the step
    from that source: a library of its own, named by a hash that holds
    the prelude; the built-in losses' library has none."""
    from repro_torch.kernels import _build
    body = "return (y - wx - a) / (1.0f + xsq);"
    custom = tdual.Loss("custom", tdual.squared.value,
                        tdual.squared.conj_neg, tdual.squared.coord_delta,
                        gamma=1.0, cuda=body)
    assert t_kernel.loss_id(custom) == t_kernel.CUSTOM_ID == 4
    head = t_kernel.prelude(custom)
    assert "#define SDCA_CUSTOM_LOSS" in head and body in head
    assert "sdca_custom_coord_delta(" in head
    assert t_kernel.prelude(tdual.squared) == ""
    src = next(s for s in _build.sources() if s.stem == "sdca_block")
    assert "SDCA_CUSTOM_LOSS" in src.read_text()
    assert _build.library_path(src, head) != _build.library_path(src)
    assert _build.library_path(src, "") == _build.library_path(src)


def test_block_solve_matches_jax():
    """One CoCoA round: the (K, H) draws from one key are integer-exact,
    the averaged iterates agree to float32."""
    X, y, alpha, w, _, _ = _block("squared", 4, 32, 8, 1, seed=4)
    kj = jax.random.PRNGKey(9)
    na, nw, dw = t_solve(*_torch(X, y, alpha, w), prng.as_key(
        np.asarray(kj)), loss=tdual.squared, lam=0.1, m_total=128,
        num_steps=96)
    ja, jw, jdw = j_solve(X, y, alpha, w, kj, loss=jdual.squared, lam=0.1,
                          m_total=128, num_steps=96)
    np.testing.assert_allclose(na.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(nw.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), **TOL)


@pytest.mark.parametrize("loss_name", ["squared", "logistic"])
def test_local_sdca_matches_jax(loss_name):
    X, y, alpha, w, _, _ = _block(loss_name, 1, 40, 6, 1, seed=5)
    X, y, alpha = X[0], y[0], alpha[0]
    kj = jax.random.PRNGKey(4)
    da, dw = t_local_sdca(*_torch(X, y, alpha, w), prng.as_key(
        np.asarray(kj)), loss=tdual.get_loss(loss_name), lam=0.1,
        m_total=80, num_steps=120)
    ja, jw = j_local_sdca(jnp.asarray(X), jnp.asarray(y), jnp.asarray(alpha),
                          jnp.asarray(w), kj, loss=jloss(loss_name),
                          lam=0.1, m_total=80, num_steps=120)
    np.testing.assert_allclose(da.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jw), **TOL)
