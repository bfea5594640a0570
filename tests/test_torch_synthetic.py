"""The port's synthetic datasets (repro_torch.data.synthetic) against the
JAX package's, with the reference's default keys: the same key splits,
bit-exact uniforms, normals within erfinv's ulps, and float32 products
summed in another order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402

torch.set_num_threads(1)

# |port - reference| per element, as a share of max(1, max|reference|):
# the draws differ by erfinv's few ulp (up to ~1e-5 absolute in the far
# tails, tests/test_torch_prng.py), and a length-100 float32 dot product
# summed in another order adds ~1e-6.  The labels of the classification
# and wine sets are thresholded or rounded, and must be equal.
TOL = 5e-5

CASES = {
    "gaussian_regression": dict(m=600, d=100),
    "gaussian_classification": dict(m=600, d=100),
    "wine_like": dict(m=1596),
}


def close(got, want):
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("name", sorted(CASES))
def test_default_key_matches_the_reference(name):
    X, y = getattr(tsyn, name)(device="cpu", **CASES[name])
    Xj, yj = getattr(jsyn, name)(**CASES[name])
    assert X.dtype == y.dtype == torch.float32
    close(X, Xj)
    if name == "gaussian_regression":
        close(y, yj)
    else:
        np.testing.assert_array_equal(y.numpy(), np.asarray(yj))


@pytest.mark.parametrize("name", sorted(CASES))
def test_explicit_key_matches_the_reference(name):
    kw = dict(m=200, d=24) if name != "wine_like" else dict(m=300)
    X, y = getattr(tsyn, name)(key=prng.PRNGKey(5), device="cpu", **kw)
    Xj, yj = getattr(jsyn, name)(key=jax.random.PRNGKey(5), **kw)
    close(X, Xj)
    close(y, yj)


def test_seed_path_is_reproducible_and_exclusive_with_key():
    a = tsyn.gaussian_regression(64, 8, seed=3, device="cpu")
    b = tsyn.gaussian_regression(64, 8, seed=3, device="cpu")
    assert all(torch.equal(u, v) for u, v in zip(a, b, strict=True))
    with pytest.raises(ValueError, match="not both"):
        tsyn.gaussian_regression(64, 8, key=prng.PRNGKey(0), seed=3,
                                 device="cpu")
