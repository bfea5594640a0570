"""The port's threefry key replay (repro_torch.core.prng) against
jax.random, integer-exact: keys, splits and randint draws, single and
batched, with ranges that are not powers of two."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.core import prng  # noqa: E402

torch.set_num_threads(1)

SEEDS = [0, 1, 42, 123456789, 2**31 - 1]


def _np(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_matches_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  _np(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 2, 3, 9, 17])
def test_split_matches_jax(seed, num):
    got = prng.split(prng.PRNGKey(seed), num).numpy()
    np.testing.assert_array_equal(
        got, _np(jax.random.split(jax.random.PRNGKey(seed), num)))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("shape,maxval", [
    ((5,), 100), ((1000,), 37), ((7, 13), 1000), ((64,), 100_000),
    ((3,), 1), ((256,), 2**20)])
def test_randint_matches_jax(seed, shape, maxval):
    """randint(key, shape, 0, maxval): ranges below and above 2**16 (the
    multiplier's uint32 wrap), not powers of two, and a 2-d shape."""
    got = prng.randint(prng.PRNGKey(seed), shape, 0, maxval).numpy()
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, 0,
                                         maxval))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_randint_batched_keys_per_row_maxval():
    """The executor's draw: one key and one block size per leaf."""
    keys = jax.random.split(jax.random.PRNGKey(5), 6)
    mbs = np.array([10, 37, 64, 100, 7, 1000])
    want = np.stack([np.asarray(jax.random.randint(k, (50,), 0, int(m)))
                     for k, m in zip(keys, mbs, strict=True)])
    got = prng.randint(prng.as_key(np.asarray(keys)), (50,), 0,
                       torch.as_tensor(mbs)).numpy()
    np.testing.assert_array_equal(got, want)


def test_chained_split_replays_the_legacy_chain():
    """key, *subs = split(key, 1 + K), T times: the per-round threading
    every executor replays."""
    kj, kt = jax.random.PRNGKey(11), prng.PRNGKey(11)
    for _ in range(4):
        sj, st = jax.random.split(kj, 5), prng.split(kt, 5)
        np.testing.assert_array_equal(st.numpy(), _np(sj))
        kj, kt = sj[0], st[0]


@pytest.mark.parametrize("seed", [0, 7, 11, 17, 2**31 - 1])
@pytest.mark.parametrize("shape,lo,hi", [
    ((5,), 0.0, 1.0), ((1000,), 0.0, 1.0), ((37, 13), -2.5, 3.0),
    ((4096,), float(np.nextafter(np.float32(-1), np.float32(0))), 1.0)])
def test_uniform_matches_jax_bitwise(seed, shape, lo, hi):
    got = prng.uniform(prng.PRNGKey(seed), shape, lo, hi).numpy()
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                         minval=lo, maxval=hi))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def normal_tolerance(z: np.ndarray) -> np.ndarray:
    """The normals' tolerance: 4 float32 ulp of the (exact) uniform u,
    carried through d/du sqrt(2) erfinv(u) = sqrt(pi/2) exp(z^2 / 2),
    plus 4 ulp of z.  torch.erfinv and XLA's erfinv are different
    polynomials; in the tails erfinv's own conditioning sets the error."""
    z = np.abs(z.astype(np.float64))
    return 4.0 * (2.0 ** -24 * np.sqrt(np.pi / 2) * np.exp(z * z / 2)
                  + np.spacing(z.astype(np.float32)))


@pytest.mark.parametrize("seed", [0, 7, 11, 17, 123])
@pytest.mark.parametrize("shape", [(5,), (4000,), (37, 13)])
def test_normal_matches_jax_within_erfinv_ulps(seed, shape):
    got = prng.normal(prng.PRNGKey(seed), shape).numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    assert got.dtype == want.dtype == np.float32 and got.shape == shape
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= normal_tolerance(want)).all(), err.max()


def test_batched_uniform_is_one_draw_per_key():
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    want = np.stack([np.asarray(jax.random.uniform(k, (9,))) for k in keys])
    got = prng.uniform(prng.as_key(np.asarray(keys)), (9,)).numpy()
    np.testing.assert_array_equal(got, want)
