"""The port's flash attention against the JAX package's: the plain version
(kernels/flash_attention/ref.py) against the JAX oracle, and the wrapper's
CPU path (which runs the plain version with the kernel's query offset)
against the Pallas kernel in interpret mode, where the offset and the
pruned k-loop bounds live.  The CUDA kernel itself is held against the
plain version on the card in tests/test_torch_cuda_lm.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import \
    flash_attention_kernel as j_kernel  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as j_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref as t_ref  # noqa: E402

torch.set_num_threads(1)

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py's tolerances: float32 softmax in both, summed in
# other orders; in bf16 the outputs are rounded to 8 mantissa bits
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(B, Sq, Sk, H, KV, D, dtype, seed=0):
    """The same inputs for both packages: numpy draws rounded to the
    working dtype once, then handed to each."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D))]
    _, jdt, tdt = DTYPES[dtype]
    ts = [torch.from_numpy(a).to(tdt) for a in arrays]
    js = [jnp.asarray(t.float().numpy()).astype(jdt) for t in ts]
    return js, ts


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,KV,D", [
    (1, 128, 2, 2, 32),     # MHA
    (2, 64, 4, 2, 64),      # GQA 2:1
    (1, 64, 8, 1, 16),      # MQA
    (1, 32, 10, 1, 256),    # the serving path's heads, short
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None), (False, 24)])
def test_ref_matches_jax_ref(B, S, H, KV, D, dtype, causal, window):
    (jq, jk, jv), (tq, tk, tv) = _qkv(B, S, S, H, KV, D, dtype)
    want = j_ref(jq, jk, jv, causal=causal, window=window)
    got = t_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, dtype)


def test_ref_aligned_suffix_default_when_sq_below_sk():
    """seq_offset=None is the reference's Sk - Sq: the queries are the last
    Sq positions of the keys."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 16, 48, 4, 2, 32, "float32")
    want = j_ref(jq, jk, jv, causal=True, window=20)
    _close(t_ref(tq, tk, tv, causal=True, window=20), want, "float32")
    _close(t_ref(tq, tk, tv, causal=True, window=20, seq_offset=32), want,
           "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk,offset,causal,window,bq,bk", [
    (64, 64, 0, True, None, 32, 32),
    (64, 64, 0, True, 16, 16, 16),      # window prunes k blocks
    (32, 128, 96, True, 40, 32, 32),    # queries late in the keys
    (32, 128, 48, True, None, 32, 64),  # an offset that is not a suffix
    (64, 64, 0, False, 24, 32, 32),     # window without causality
    (64, 64, 0, False, None, 64, 16),
])
def test_wrapper_cpu_path_matches_pallas_kernel(dtype, Sq, Sk, offset,
                                                causal, window, bq, bk):
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, Sq, Sk, 4, 2, 32, dtype, seed=1)
    want = j_kernel(jq, jk, jv, causal=causal, window=window, block_q=bq,
                    block_k=bk, seq_offset=offset, interpret=True)
    before = t_kernel.LAUNCHES
    got = flash_attention(tq, tk, tv, causal=causal, window=window,
                          seq_offset=offset)
    assert t_kernel.LAUNCHES == before   # no kernel on CPU tensors
    _close(got, want, dtype)


def test_rows_that_see_no_key_are_zero_in_both():
    """A window with seq_offset past the keys: the reference divides by
    l + 1e-30, so such rows are exactly 0."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 16, 16, 2, 2, 16, "float32")
    want = np.asarray(j_kernel(jq, jk, jv, causal=True, window=4,
                               block_q=16, block_k=16, seq_offset=40,
                               interpret=True))
    got = flash_attention(tq, tk, tv, causal=True, window=4, seq_offset=40)
    assert np.all(want == 0) and torch.all(got == 0)


def test_wrapper_refuses_bad_arguments_on_any_device():
    (_, _, _), (tq, tk, tv) = _qkv(1, 16, 16, 3, 2, 16, "float32")
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(tq, tk, tv)
    (_, _, _), (tq, tk, tv) = _qkv(1, 16, 16, 4, 2, 16, "float32")
    with pytest.raises(ValueError, match="seq_offset"):
        flash_attention(tq, tk, tv, seq_offset=-1)
    with pytest.raises(ValueError, match="window"):
        flash_attention(tq, tk, tv, window=0)
    with pytest.raises(ValueError):
        flash_attention(tq[0], tk, tv)
    # meta tensors take the counting route (kernels/counting.py): the same
    # checks refuse bad arguments there, and a good call launches nothing
    # and returns an empty output of q's shape
    mq, mk, mv = (t.to("meta") for t in (tq, tk, tv))
    with pytest.raises(ValueError, match="window"):
        flash_attention(mq, mk, mv, window=0)
    from repro_torch.kernels.flash_attention import kernel as fk
    n0 = fk.LAUNCHES
    out = flash_attention(mq, mk, mv)
    assert out.device.type == "meta" and out.shape == mq.shape
    assert fk.LAUNCHES == n0
