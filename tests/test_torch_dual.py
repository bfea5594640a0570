"""The port's losses and objectives (repro_torch.core.dual) against the
JAX package's on the same numpy arrays, plus the logistic coord_delta
shortfall both packages share."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import dual as jdual  # noqa: E402
from repro_torch.core import dual as tdual  # noqa: E402

torch.set_num_threads(1)

LOSSES = ["squared", "hinge", "smooth_hinge_1", "smooth_hinge_0.5",
          "logistic"]
# float32 elementwise formulas evaluated by two libraries: they may differ
# by a rounding or two (fused multiply-adds, division by reciprocal)
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(name, n=257, seed=0):
    rng = np.random.default_rng(seed)
    wx = rng.standard_normal(n).astype(np.float32)
    if name == "squared":
        y = rng.standard_normal(n).astype(np.float32)
        alpha = rng.standard_normal(n).astype(np.float32)
    else:                     # labels +-1, dual-feasible alpha*y in (0, 1)
        y = np.where(rng.standard_normal(n) >= 0, 1.0, -1.0).astype(
            np.float32)
        alpha = (rng.uniform(0.01, 0.99, n) * y).astype(np.float32)
    xsq = rng.uniform(0.05, 3.0, n).astype(np.float32)
    return wx, alpha, y, xsq


def _both(fn_j, fn_t, *arrays):
    got = fn_t(*[torch.from_numpy(a) for a in arrays]).numpy()
    want = np.asarray(fn_j(*[jnp.asarray(a) for a in arrays]))
    return got, want


@pytest.mark.parametrize("name", LOSSES)
def test_value_and_conj_neg_match_jax(name):
    lj, lt = jdual.get_loss(name), tdual.get_loss(name)
    wx, alpha, y, _ = _inputs(name)
    np.testing.assert_allclose(*_both(lj.value, lt.value, wx, y), **TOL)
    np.testing.assert_allclose(*_both(lj.conj_neg, lt.conj_neg, alpha, y),
                               **TOL)
    assert lt.gamma == lj.gamma and lt.name == lj.name


@pytest.mark.parametrize("name", LOSSES)
def test_coord_delta_matches_jax(name):
    """Closed forms to a rounding; the logistic loss's 8 Newton steps
    amplify one-ulp differences near the edge of (0, 1), so it is held to
    1e-4 (the same float32 inputs, two libraries' log and division)."""
    lj, lt = jdual.get_loss(name), tdual.get_loss(name)
    args = _inputs(name)
    got, want = _both(lj.coord_delta, lt.coord_delta, *args)
    tol = dict(rtol=1e-4, atol=1e-5) if name == "logistic" else TOL
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("name", ["squared", "smooth_hinge_1", "logistic"])
def test_objectives_match_jax(name):
    rng = np.random.default_rng(1)
    m, d, lam = 64, 7, 0.05
    X = rng.standard_normal((m, d)).astype(np.float32)
    _, alpha, y, _ = _inputs(name, n=m, seed=2)
    lj, lt = jdual.get_loss(name), tdual.get_loss(name)
    Xt, at, yt = (torch.from_numpy(v) for v in (X, alpha, y))
    wt = tdual.w_of_alpha(at, Xt, lam)
    np.testing.assert_allclose(
        wt.numpy(), np.asarray(jdual.w_of_alpha(alpha, X, lam)), **TOL)
    for fj, ft, args_j, args_t in [
        (jdual.primal_value, tdual.primal_value,
         (wt.numpy(), X, y), (wt, Xt, yt)),
        (jdual.dual_value, tdual.dual_value, (alpha, X, y), (at, Xt, yt)),
        (jdual.duality_gap, tdual.duality_gap, (alpha, X, y), (at, Xt, yt)),
    ]:
        np.testing.assert_allclose(float(ft(*args_t, lt, lam)),
                                   float(fj(*args_j, lj, lam)),
                                   rtol=1e-5, atol=1e-6)


def test_ridge_dual_optimum_matches_jax():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((40, 6)).astype(np.float32)
    y = rng.standard_normal(40).astype(np.float32)
    got = tdual.ridge_dual_optimum(torch.from_numpy(X), torch.from_numpy(y),
                                   0.1).numpy()
    want = np.asarray(jdual.ridge_dual_optimum(X, y, 0.1))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_registry_builds_smooth_hinge_and_names_unknown_losses():
    loss = tdual.get_loss("smooth_hinge_0.25")
    assert loss.kind == "smooth_hinge" and loss.g == 0.25
    assert tdual.get_loss(loss) is loss
    with pytest.raises(KeyError):
        tdual.get_loss("nope")
    with pytest.raises(ValueError):
        tdual.get_loss("smooth_hinge_0")


def test_logistic_newton_shortfall_seed_54_in_both_packages():
    """tests/test_properties.py::test_coord_delta_is_argmax draws seed 54
    for the logistic loss on some runs: there the 8 Newton steps stop
    short of the scalar maximizer, and a step of +-0.01 beats the returned
    delta by more than the 1e-5 that test allows.  The port keeps the 8
    steps, so it shows the same shortfall (a fault of the method's step
    count, recorded in ROADMAP C; the JAX test is seed-dependent)."""
    key = jax.random.PRNGKey(54)
    ks = jax.random.split(key, 4)
    wx = float(jax.random.normal(ks[0], ()))
    y = float(jnp.sign(jax.random.normal(ks[1], ())))
    alpha = float(jax.random.uniform(ks[2], (), minval=0.1, maxval=0.9)) * y
    xsq = float(jax.random.uniform(ks[3], (), minval=0.1, maxval=2.0))

    def best_gain(loss, as_array):
        def scalar_dual(delta):
            return (-0.5 * xsq * delta**2 - wx * delta
                    - float(loss.conj_neg(as_array(alpha + delta),
                                          as_array(y))))
        d_star = float(loss.coord_delta(*(as_array(v)
                                          for v in (wx, alpha, y, xsq))))
        f_star = scalar_dual(d_star)
        gains = [scalar_dual(d_star + eps) - f_star
                 for eps in (-0.05, -0.01, 0.01, 0.05)
                 if 0.0 <= (alpha + d_star + eps) * y <= 1.0]
        return d_star, max(gains)

    d_j, gain_j = best_gain(jdual.logistic,
                            lambda v: jnp.asarray(v, jnp.float32))
    d_t, gain_t = best_gain(tdual.logistic,
                            lambda v: torch.tensor(v, dtype=torch.float32))
    assert gain_j > 1e-5 and gain_t > 1e-5      # both fall short
    np.testing.assert_allclose(d_t, d_j, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gain_t, gain_j, rtol=1e-2)
