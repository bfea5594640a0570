"""The port's edge compression (repro_torch.core.compression) against the
JAX package's, run under jax.jit as the reference's executors run it:
spec tables, int8 codes / scales / roundtrips and top-k selections
(ties included) integer- and bit-exact, and the error-feedback
compressors' invariant."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import compression as jc  # noqa: E402
from repro_torch.core import compression as tc  # noqa: E402

torch.set_num_threads(1)

SPECS = [None, "", "none", "int8", "topk", "topk_0.25", "topk_0.05",
         "topk_1", (0, 0.0), (1, 0.0), (2, 0.3)]


def t(x):
    return torch.from_numpy(np.asarray(x))


def bits_equal(got: torch.Tensor, want) -> None:
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_spec_tables_match():
    for spec in SPECS:
        k, f = tc.parse_spec(spec)
        assert (k, f) == jc.parse_spec(spec)
        assert tc.spec_name(k, f) == jc.spec_name(k, f)
        assert tc.wire_ratio(k, f) == jc.wire_ratio(k, f)
        assert tc.quality(k, f) == jc.quality(k, f)
    for bad in ("gzip", "topk_0", "topk_1.5", (7, 0.0)):
        with pytest.raises(ValueError):
            tc.parse_spec(bad)
    with pytest.raises(TypeError):
        tc.parse_spec(3)
    assert tc.INT8_RATIO == jc.INT8_RATIO == 0.28125
    assert (tc.BLOCK, tc.KIND_NONE, tc.KIND_INT8, tc.KIND_TOPK,
            tc.DEFAULT_TOPK_FRAC) == (jc.BLOCK, jc.KIND_NONE, jc.KIND_INT8,
                                      jc.KIND_TOPK, jc.DEFAULT_TOPK_FRAC)


def int8_inputs():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((128, 512)) * 1e-3).astype(np.float32)
    odd = rng.standard_normal((6, 45)).astype(np.float32)   # d % 32 != 0
    odd[2] = 0.0                                             # all-zero rows
    odd[4, :32] = 0.0                                        # one zero block
    return {"(128,512)": x, "(6,45)": odd,
            "(100,)": rng.standard_normal(100).astype(np.float32),
            "(3,5,7)": rng.standard_normal((3, 5, 7)).astype(np.float32)}


INT8_CASES = [(name, kl) for name, x in sorted(int8_inputs().items())
              for kl in range(min(x.ndim, 2))]


@pytest.mark.parametrize("name,keep_leading", INT8_CASES)
def test_int8_codes_scales_and_roundtrip_equal_jitted_reference(
        name, keep_leading):
    x = int8_inputs()[name]
    jq = jax.jit(lambda v: jc.quantize_int8(v, keep_leading=keep_leading))
    jr = jax.jit(lambda v: jc.int8_roundtrip(v, keep_leading=keep_leading))
    codes, scale = tc.quantize_int8(t(x), keep_leading=keep_leading)
    jcodes, jscale = jq(x)
    bits_equal(codes, jcodes)
    bits_equal(scale, jscale)
    rt = tc.int8_roundtrip(t(x), keep_leading=keep_leading)
    bits_equal(rt, jr(x))
    bits_equal(tc.dequantize_int8(codes, scale, x.shape, torch.float32,
                                  keep_leading=keep_leading), jr(x))


def test_int8_scale_is_the_jitted_reciprocal_multiply():
    """The jitted reference scales by amax * f32(1/127), not amax / 127:
    the two differ in the last ulp for some blocks; the port follows the
    program the reference actually runs."""
    x = int8_inputs()["(128,512)"]
    blocks = np.abs(x.reshape(128, -1, tc.BLOCK)).max(-1)
    divided = blocks / np.float32(127.0)
    _, jscale = jax.jit(lambda v: jc.quantize_int8(v, keep_leading=1))(x)
    assert (np.asarray(jscale) != divided).any()
    np.testing.assert_array_equal(
        np.asarray(jscale), blocks * (np.float32(1) / np.float32(127)))


def tied(seed, shape):
    """Magnitudes from a small set, random signs: many exact ties."""
    rng = np.random.default_rng(seed)
    mag = rng.integers(0, 4, size=shape).astype(np.float32) * 0.5
    return (mag * rng.choice([-1.0, 1.0], size=shape)).astype(np.float32)


@pytest.mark.parametrize("k", [1, 3, 8, 24, 0, 99])
@pytest.mark.parametrize("kind", ["normal", "tied"])
def test_topk_roundtrip_equals_jitted_reference(kind, k):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((5, 24)).astype(np.float32) if kind == "normal" \
        else tied(k, (5, 24))
    want = jax.jit(lambda v: jc.topk_roundtrip(v, k))(x)
    bits_equal(tc.topk_roundtrip(t(x), k), want)
    bits_equal(tc.topk_roundtrip(t(x[0]), k), jc.topk_roundtrip(x[0], k))


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.3, 1.0])
def test_topk_sparsify_indices_with_ties_equal_reference(frac):
    x = tied(3, (6, 10))
    vals, idx = tc.topk_sparsify(t(x), frac)
    jvals, jidx = jc.topk_sparsify(jnp.asarray(x), frac)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    bits_equal(vals, jvals)
    bits_equal(tc.topk_densify(vals, idx, x.shape, torch.float32),
               jc.topk_densify(jvals, jidx, x.shape, jnp.float32))
    v0, i0 = tc.topk_sparsify(torch.zeros(0), frac)
    assert v0.numel() == 0 and i0.numel() == 0


def test_topk_count_matches():
    for size in (0, 1, 5, 10, 33, 512, 1000):
        for frac in (0.001, 0.01, 0.1, 0.25, 0.5, 1.0):
            assert tc.topk_count(size, frac) == jc.topk_count(size, frac)


def test_compressors_fields_and_registry_match():
    for spec in ("none", "int8", "topk", "topk_0.25"):
        a, b = tc.get_compressor(spec), jc.get_compressor(spec)
        assert (a.name, a.ratio) == (b.name, b.ratio)
    c = tc.TopKCompressor(0.25)
    with pytest.raises(dataclasses.FrozenInstanceError):
        c.frac = 0.5
    with pytest.raises(ValueError):
        tc.TopKCompressor(0.0)
    assert tc.COMPRESSORS["topk"]().frac == tc.DEFAULT_TOPK_FRAC


@pytest.mark.parametrize("spec", ["int8", "topk_0.1"])
def test_compressor_wire_and_residual_equal_jitted_reference(spec):
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((4, 40)).astype(np.float32),
            "b": [rng.standard_normal(70).astype(np.float32)]}
    res = {"a": (0.1 * rng.standard_normal((4, 40))).astype(np.float32),
           "b": [(0.1 * rng.standard_normal(70)).astype(np.float32)]}
    jcomp, tcomp = jc.get_compressor(spec), tc.get_compressor(spec)

    def jref(tr, rs):
        wire, new_res = jcomp.compress(tr, rs)
        return jcomp.decompress(wire), new_res
    jdec, jres = jax.jit(jref)(tree, res)
    ttree = {"a": t(tree["a"]), "b": [t(tree["b"][0])]}
    tres = {"a": t(res["a"]), "b": [t(res["b"][0])]}
    wire, new_res = tcomp.compress(ttree, tres)
    dec = tcomp.decompress(wire)
    bits_equal(dec["a"], jdec["a"])
    bits_equal(dec["b"][0], jdec["b"][0])
    bits_equal(new_res["a"], jres["a"])
    bits_equal(new_res["b"][0], jres["b"][0])
    zeros = tcomp.init_residual(ttree)
    assert zeros["a"].shape == (4, 40) and not zeros["b"][0].any()


@pytest.mark.parametrize("spec", ["int8", "topk_0.1", "none"])
def test_error_feedback_sent_plus_residual_is_truth(spec):
    """sent-so-far + residual == truth-so-far (reference
    tests/test_compression.py::test_error_feedback_recovers_truncated_mass),
    through the Compressor API on a list of tensors."""
    g = torch.Generator().manual_seed(0)
    delta = [torch.randn(64, generator=g), torch.randn(3, 33, generator=g)]
    comp = tc.get_compressor(spec)
    res = comp.init_residual(delta)
    got = [torch.zeros_like(d) for d in delta]
    for step in range(1, 41):
        wire, res = comp.compress(delta, res)
        got = [a + b for a, b in zip(got, comp.decompress(wire),
                                     strict=True)]
        for s, r, d in zip(got, res, delta, strict=True):
            np.testing.assert_allclose((s + r).numpy(), (step * d).numpy(),
                                       rtol=1e-4, atol=1e-4)
    for r, d in zip(res, delta, strict=True):
        assert float(r.abs().max()) <= float(d.abs().max()) * d.numel()
