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
