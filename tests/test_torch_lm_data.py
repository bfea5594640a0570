"""The LM data stream (repro_torch/data/lm.py) and the draws it is made
of (core/prng.py: fold_in, bernoulli, gumbel, categorical), against
jax.random and the JAX package's ``lm_batch`` on the same seeds.

Tokens, labels, keys, Bernoulli draws and the embeddings stub are equal
bit for bit.  The Gumbel noise is ``-log(-log(u))`` of bit-exact
uniforms; XLA's float32 log is not torch's (they agree on ~88% of
inputs, otherwise by one ulp), so the noise agrees to GUMBEL_ULP, and the
argmax over it -- the token -- is held exactly over many steps, seeds
and vocabulary sizes.  An ulp of the inner log y = -log(u) moves the
noise g = -log(y) by ulp(y) / y, so the bound is GUMBEL_ULP * (ulp(g) +
ulp(y) / y).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.data.lm import lm_batch as jax_lm_batch  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data.lm import lm_batch, synthetic_lm_batches  # noqa: E402

# two float32 logs, each within an ulp of the other library's
GUMBEL_ULP = 4
CFG = dict(name="t", family="dense", num_layers=2, d_model=32, num_heads=4,
           num_kv_heads=2, d_ff=64, vocab_size=64)


@pytest.mark.parametrize("data", [0, 1, 7, 2 ** 31 + 5, 2 ** 32 - 1])
@pytest.mark.parametrize("seed", [0, 3, 123456])
def test_fold_in_is_jax_fold_in(seed, data):
    want = np.asarray(jax.random.key_data(
        jax.random.fold_in(jax.random.PRNGKey(seed), data)))
    got = prng.fold_in(prng.PRNGKey(seed), data).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_bernoulli_is_jax_bernoulli(p):
    want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(4), p, (37, 5)))
    got = prng.bernoulli(prng.PRNGKey(4), p, (37, 5)).numpy()
    np.testing.assert_array_equal(got, want)


def test_gumbel_rows_agree_to_a_few_ulp():
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(2), (30, 500)))
    got = prng.gumbel_rows(prng.PRNGKey(2), (30, 500), 0, 30).numpy()
    y = np.exp(-want.astype(np.float64))
    bound = GUMBEL_ULP * (np.spacing(np.abs(want))
                          + np.spacing(y.astype(np.float32)) / y)
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("V", [2, 64, 1000])
@pytest.mark.parametrize("shape", [(3, 17), (1, 1), (5,)])
def test_categorical_is_jax_categorical(shape, V):
    logits = np.linspace(-3, 1, V).astype(np.float32)
    for seed in range(4):
        want = np.asarray(jax.random.categorical(
            jax.random.PRNGKey(seed), jnp.asarray(logits), shape=shape))
        got = prng.categorical(prng.PRNGKey(seed), torch.from_numpy(logits),
                               shape)
        np.testing.assert_array_equal(got.numpy(), want)


def test_a_row_block_draw_is_the_slice_of_the_whole_draw():
    """Each row block draws its counters offset into the whole draw, in
    chunks smaller than a row or spanning rows, and equals the slice."""
    logits = torch.from_numpy(np.linspace(-2, 0, 300).astype(np.float32))
    key = prng.PRNGKey(9)
    whole = prng.categorical(key, logits, (6, 11))
    for rows in (slice(0, 2), slice(2, 3), slice(3, 6)):
        for chunk in (1, 300 * 4, 300 * 11 * 2, 1 << 24):
            part = prng.categorical(key, logits, (6, 11), rows=rows,
                                    chunk_elems=chunk)
            assert torch.equal(part, whole[rows])


@pytest.mark.parametrize("V", [64, 256, 1000])
def test_lm_batch_tokens_are_the_reference_tokens(V):
    jc, tc = JConfig(**dict(CFG, vocab_size=V)), ModelConfig(
        **dict(CFG, vocab_size=V))
    for seed in range(3):
        for step in range(8):
            want = jax_lm_batch(jc, 4, 33, step, seed)
            got = lm_batch(tc, 4, 33, step, seed, device="cpu")
            for k in ("tokens", "labels"):
                assert got[k].dtype == torch.int32
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))


def test_each_replica_draws_its_rows_of_the_batch():
    cfg = ModelConfig(**CFG)
    whole = lm_batch(cfg, 8, 16, 3, seed=1, device="cpu")
    for r in range(4):
        part = lm_batch(cfg, 8, 16, 3, seed=1, rows=slice(2 * r, 2 * r + 2),
                        device="cpu")
        for k in whole:
            assert torch.equal(part[k], whole[k][2 * r:2 * r + 2])


def test_the_embeddings_stub_is_the_reference():
    jc = JConfig(**dict(CFG, input_mode="embeddings"))
    tc = ModelConfig(**dict(CFG, input_mode="embeddings"))
    want = jax_lm_batch(jc, 2, 16, 5, 2)["embeds"]
    got = lm_batch(tc, 2, 16, 5, 2, device="cpu")["embeds"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_the_stream_is_a_pure_function_of_seed_and_step():
    cfg = ModelConfig(**CFG)
    it = synthetic_lm_batches(cfg, 2, 8, seed=3, start=5, device="cpu")
    for step in (5, 6, 7):
        got = next(it)
        assert torch.equal(got["tokens"], lm_batch(cfg, 2, 8, step, 3,
                                                   device="cpu")["tokens"])
