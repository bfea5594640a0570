"""The port's losses and objectives (repro_torch.core.dual) against the
JAX package's on the same numpy arrays.  The port's logistic step runs
damped Newton steps until one moves its coordinate by at most 1e-6, at most
16, where the reference runs 8, which stop short of the scalar maximizer on
some draws (a stated departure): its parity is held against the reference's
own functions at 16 steps (:func:`jloss`)."""
import functools

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
# the logistic step against the reference's at the same Newton steps
NEWTON_TOL = dict(rtol=1e-4, atol=1e-6)


def jloss(name):
    """The reference's loss ``name``; its logistic built from the
    reference's own functions at the port's Newton step count."""
    if name == "logistic":
        return jdual.Loss("logistic", jdual._log_value, jdual._log_conj_neg,
                          functools.partial(
                              jdual._log_coord_delta,
                              newton_steps=tdual.LOGISTIC_NEWTON_STEPS),
                          gamma=0.25)
    return jdual.get_loss(name)


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
    """Closed forms to a rounding; the logistic loss's Newton steps
    amplify one-ulp differences near the edge of (0, 1), so it is held to
    1e-4 (the same float32 inputs, two libraries' log and division)."""
    lj, lt = jloss(name), tdual.get_loss(name)
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
    for the logistic loss on some runs: there the reference's 8 Newton
    steps stop short of the scalar maximizer, and a step of +-0.01 beats
    the returned delta by more than the 1e-5 that test allows.  The port's
    steps (at most 16) reach it, and agree with the reference's own step
    function run for 16 steps."""
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

    def as_jax(v):
        return jnp.asarray(v, jnp.float32)

    def as_torch(v):
        return torch.tensor(v, dtype=torch.float32)

    _, gain_8 = best_gain(jdual.logistic, as_jax)
    d_j, gain_j = best_gain(jloss("logistic"), as_jax)
    d_t, gain_t = best_gain(tdual.logistic, as_torch)
    assert gain_8 > 1e-5                         # the reference falls short
    assert gain_t <= 1e-5 and gain_j <= 1e-5     # 16 steps reach it
    np.testing.assert_allclose(d_t, d_j, **NEWTON_TOL)


def _property_draw(seed):
    """tests/test_torch_properties.py::test_coord_delta_is_argmax's
    logistic draw from numpy seed ``seed``: (wx, alpha, y, xsq)."""
    rng = np.random.default_rng(seed)
    wx = float(rng.standard_normal())
    y = float(np.sign(rng.standard_normal()) or 1.0)
    alpha = float(rng.uniform(0.1, 0.9)) * y
    xsq = float(rng.uniform(0.1, 2.0))
    return wx, alpha, y, xsq


def test_logistic_step_is_the_argmax_for_every_property_seed():
    """Every seed the property test can draw (0-1000): no delta of +-0.01
    or +-0.05 inside the feasible set beats the port's logistic step by
    more than that test's 1e-5 (at the reference's 8 steps, seeds 92, 125,
    316, 835, 958 and 988 did)."""
    draws = np.array([_property_draw(s) for s in range(1001)], np.float64)
    wx, alpha, y, xsq = (torch.tensor(c, dtype=torch.float32)
                         for c in draws.T)
    d = tdual.logistic.coord_delta(wx, alpha, y, xsq).double()
    wx, alpha, y, xsq = (torch.from_numpy(c) for c in draws.T)

    def scalar_dual(delta):
        conj = tdual.logistic.conj_neg((alpha + delta).float(), y.float())
        return -0.5 * xsq * delta ** 2 - wx * delta - conj.double()

    f_star = scalar_dual(d)
    for eps in (-0.05, -0.01, 0.01, 0.05):
        trial = d + eps
        inside = ((alpha + trial) * y >= 0.0) & ((alpha + trial) * y <= 1.0)
        short = inside & (scalar_dual(trial) - 1e-5 > f_star)
        assert not bool(short.any()), torch.nonzero(short).flatten().tolist()


def test_logistic_step_matches_the_reference_at_16_newton_steps():
    """4096 random inputs through the port's logistic step and the
    reference's ``_log_coord_delta(..., newton_steps=16)``."""
    args = _inputs("logistic", n=4096, seed=7)
    got, want = _both(jloss("logistic").coord_delta,
                      tdual.logistic.coord_delta, *args)
    np.testing.assert_allclose(got, want, **NEWTON_TOL)
    assert tdual.LOGISTIC_NEWTON_STEPS == 16
