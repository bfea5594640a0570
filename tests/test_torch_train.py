"""The port's training half (models/loss.py, the train mode of
models/transformer.py, launch/steps.py::make_train_step, and the
differentiable RG-LRU scan of kernels/rglru/ops.py) against the JAX
package: ``chunked_xent`` and ``forward_train``'s loss and gradients
against ``jax.value_and_grad`` of the reference on the same weights
(carried over as numpy) and the same batch, on the tiny dense config and
recurrentgemma SMOKE; ``make_train_step`` with microbatches against the
reference's.

Tolerances: F32_TOL for float32 activations (the same arithmetic in two
libraries; the reference's associative scan and the port's sequential
scan add in other orders); with bfloat16 activations the two round
their intermediates at different points, so the loss agrees to
BF16_LOSS_RTOL and each gradient leaf to BF16_GRAD_NORM_REL of its norm.
The scan's own gradients are held to autograd through its plain loop
(SCAN_TOL) on the CPU, where both directions of the op run the plain
version; tests/test_torch_cuda_lm.py holds the kernel route on the card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import recurrentgemma_2b as jrg  # noqa: E402
from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.data.lm import lm_batch  # noqa: E402
from repro.models import loss as jloss  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import recurrentgemma_2b as trg  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels.rglru import ops as rops  # noqa: E402
from repro_torch.kernels.rglru.ref import rglru_scan_ref  # noqa: E402
from repro_torch.launch.steps import grads_of, make_train_step  # noqa: E402
from repro_torch.models import loss as tloss  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.optim.api import tree_leaves  # noqa: E402

F32_TOL = dict(rtol=2e-4, atol=2e-6)
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_NORM_REL = 0.1
SCAN_TOL = dict(rtol=1e-5, atol=1e-6)

TINY = dict(name="tiny", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
            q_chunk_size=16, logits_chunk=16, remat=False)
CONFIGS = {
    "tiny_f32": (JConfig(**dict(TINY, activation_dtype="float32")),
                 ModelConfig(**dict(TINY, activation_dtype="float32"))),
    "tiny_remat_f32": (JConfig(**dict(TINY, activation_dtype="float32",
                                      remat=True)),
                       ModelConfig(**dict(TINY, activation_dtype="float32",
                                          remat=True))),
    "rg_smoke_f32": (dataclasses.replace(jrg.SMOKE,
                                         activation_dtype="float32"),
                     dataclasses.replace(trg.SMOKE,
                                         activation_dtype="float32")),
    "rg_smoke_unrolled_f32": (
        dataclasses.replace(jrg.SMOKE, activation_dtype="float32",
                            scan_layers=False),
        dataclasses.replace(trg.SMOKE, activation_dtype="float32",
                            scan_layers=False)),
    "rg_smoke_bf16": (jrg.SMOKE, trg.SMOKE),
}


def _tensor(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _carry(tree):
    if isinstance(tree, dict):
        return {k: _carry(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_carry(v) for v in tree]
    return _tensor(tree)


def _setup(name, B=2, S=32):
    jc, tc = CONFIGS[name]
    params = jt.init_params(jc, jax.random.PRNGKey(0))
    batch = lm_batch(jc, B, S, 0)
    tparams = _carry(jax.tree.map(np.asarray, params))
    tbatch = {k: _tensor(v) for k, v in batch.items()}
    return jc, tc, params, batch, tparams, tbatch


def _norm_rel(a, b):
    a = np.asarray(a, np.float32)
    return np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_chunked_xent_matches_the_reference(chunk):
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 32, 16)).astype(np.float32)
    un = rng.standard_normal((16, 50)).astype(np.float32)
    lab = rng.integers(0, 50, (2, 32)).astype(np.int32)
    mask = (rng.random((2, 32)) > 0.2).astype(np.float32)

    def jfn(h, un):
        return jloss.chunked_xent(h, un, jnp.asarray(lab), jnp.asarray(mask),
                                  chunk)[0]
    (jl, (jgh, jgu)) = jax.value_and_grad(jfn, argnums=(0, 1))(h, un)
    th = torch.from_numpy(h).requires_grad_(True)
    tu = torch.from_numpy(un).requires_grad_(True)
    tl, tn = tloss.chunked_xent(th, tu, torch.from_numpy(lab),
                                torch.from_numpy(mask), chunk)
    gh, gu = torch.autograd.grad(tl, (th, tu))
    np.testing.assert_allclose(tl.item(), float(jl), **F32_TOL)
    assert float(tn) == float(mask.sum())
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), **F32_TOL)
    np.testing.assert_allclose(gu.numpy(), np.asarray(jgu), **F32_TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_train_loss_and_grads_match_the_reference(name):
    jc, tc, params, batch, tparams, tbatch = _setup(name)
    (jtot, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jt.forward_train(jc, p, batch), has_aux=True))(params)
    tg, tm = grads_of(tc, tparams, tbatch)
    jleaves = jax.tree.leaves(jg)
    tleaves = [g.float().numpy() for g in tree_leaves(tg)]
    assert len(jleaves) == len(tleaves)
    if name.endswith("f32"):
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **F32_TOL)
        for a, b in zip(jleaves, tleaves, strict=True):
            np.testing.assert_allclose(b, np.asarray(a, np.float32),
                                       **F32_TOL)
    else:
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=BF16_LOSS_RTOL)
        for a, b in zip(jleaves, tleaves, strict=True):
            assert _norm_rel(a, b) < BF16_GRAD_NORM_REL
    assert float(tm["tokens"]) == float(jm["tokens"])


def test_stacked_and_listed_blocks_are_one_model():
    _, tc, _, _, tparams, tbatch = _setup("rg_smoke_f32")
    listed = dict(tparams)
    n = next(iter(tree_leaves(tparams["blocks"]))).shape[0]
    listed["blocks"] = [tt.block_params(tparams, i) for i in range(n)]
    a = tt.forward_train(tc, tparams, tbatch)[0]
    b = tt.forward_train(tc, listed, tbatch)[0]
    assert torch.equal(a, b)
    assert torch.equal(tt.stack_blocks(listed)["blocks"]["sub0"]["ln1"],
                       tparams["blocks"]["sub0"]["ln1"])


def test_remat_changes_no_number():
    _, tc, _, _, tparams, tbatch = _setup("rg_smoke_f32")
    g0, m0 = grads_of(dataclasses.replace(tc, remat=False), tparams, tbatch)
    g1, m1 = grads_of(dataclasses.replace(tc, remat=True), tparams, tbatch)
    assert torch.equal(m0["loss"], m1["loss"])
    for a, b in zip(tree_leaves(g0), tree_leaves(g1), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_make_train_step_matches_the_reference(opt_name, microbatches):
    import repro.optim as jopt
    import repro_torch.optim as topt
    from repro.launch.steps import make_train_step as jmake
    jc, tc, params, batch, tparams, tbatch = _setup("tiny_f32", B=4)
    kw = dict(lr=0.05, momentum=0.9) if opt_name == "sgd" else dict(lr=1e-3)
    jo, to = (getattr(m, f"make_{opt_name}")(**kw) for m in (jopt, topt))
    jstep = jax.jit(jmake(jc, jo, microbatches=microbatches))
    tstep = make_train_step(tc, to, microbatches=microbatches)
    js, ts = jo.init(params), to.init(tparams)
    for i in range(2):
        b = lm_batch(jc, 4, 32, i)
        params, js, jm = jstep(params, js, b)
        tparams, ts, tm = tstep(tparams, ts, {k: _tensor(v)
                                              for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **F32_TOL)
    for a, b in zip(jax.tree.leaves(params), tree_leaves(tparams),
                    strict=True):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **F32_TOL)


# ---------------------------------------------------------------------------
# the RG-LRU scan's autograd Function
# ---------------------------------------------------------------------------
def _scan_inputs(B=2, S=37, W=12, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.rand((B, S, W), generator=g) * 0.9 + 0.05
    b = torch.randn((B, S, W), generator=g)
    h0 = torch.randn((B, W), generator=g)
    return a, b, h0


@pytest.mark.parametrize("S", [1, 2, 37])
def test_scan_gradients_equal_autograd_through_the_plain_loop(S):
    a, b, h0 = _scan_inputs(S=S)
    ins = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    refs = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    g = torch.Generator().manual_seed(1)
    dh = torch.randn(a.shape, generator=g)
    dlast = torch.randn(h0.shape, generator=g)
    h, last = rops.RGLRUScan.apply(*ins)
    hr, lastr = rglru_scan_ref(*refs)
    assert torch.equal(h, hr) and torch.equal(last, lastr)
    got = torch.autograd.grad((h * dh).sum() + (last * dlast).sum(), ins)
    want = torch.autograd.grad((hr * dh).sum() + (lastr * dlast).sum(), refs)
    for x, y in zip(got, want, strict=True):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **SCAN_TOL)


def test_reverse_scan_is_the_backward_recurrence():
    a, dh, _ = _scan_inputs()
    g = rops.reverse_scan(a, dh)
    want = torch.zeros_like(dh)
    acc = torch.zeros_like(dh[:, 0])
    for t in range(a.shape[1] - 1, -1, -1):
        nxt = a[:, t + 1] if t + 1 < a.shape[1] else torch.zeros_like(acc)
        acc = dh[:, t] + nxt * acc
        want[:, t] = acc
    np.testing.assert_allclose(g.numpy(), want.numpy(), **SCAN_TOL)


def test_scan_without_grad_is_the_bare_op():
    a, b, h0 = _scan_inputs()
    with torch.no_grad():
        h, last = rops.rglru_scan(a.requires_grad_(True), b, h0)
    assert not h.requires_grad
    assert torch.equal(h, rglru_scan_ref(a.detach(), b, h0)[0])


def test_every_rec_layer_leaf_gets_a_gradient():
    _, tc, _, _, tparams, tbatch = _setup("rg_smoke_bf16")
    grads, _ = grads_of(tc, tparams, tbatch)
    rec = [grads["blocks"]["sub0"]["mix"], grads["blocks"]["sub1"]["mix"],
           grads["tail"][0]["mix"]]
    for mix in rec:
        assert set(mix) == {"w_in", "w_gate", "conv", "w_a", "w_x", "lam",
                            "w_out"}
        for name, g in mix.items():
            assert torch.isfinite(g).all() and g.abs().sum() > 0, name


def test_kernel_and_plain_routes_give_the_same_gradients_on_the_cpu():
    _, tc, _, _, tparams, tbatch = _setup("rg_smoke_f32")
    g0, _ = grads_of(tc, tparams, tbatch)
    g1, _ = grads_of(tc, tparams, tbatch, plain_recurrence=True)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **SCAN_TOL)


def test_flash_attention_refuses_autograd():
    _, tc, _, _, tparams, tbatch = _setup("rg_smoke_f32")
    cfg = dataclasses.replace(tc, attention_impl="flash")
    with pytest.raises(RuntimeError, match="no backward"):
        grads_of(cfg, tparams, tbatch)
    with torch.no_grad():     # the forward alone still runs
        loss, _ = tt.forward_train(cfg, tparams, tbatch)
    assert torch.isfinite(loss)


def test_unported_kinds_name_the_roadmap():
    """The rwkv kind, once refused here naming ROADMAP A9, now trains: its
    sub-layer runs forward and backward with a finite output and no MoE
    aux; only an unknown kind raises."""
    cfg = dataclasses.replace(ModelConfig(**TINY), is_rwkv=True,
                              rwkv_head_dim=8)
    p = tt._init_sublayer(tt.prng.PRNGKey(0), cfg, "rwkv", torch.float32,
                          "cpu")
    x = torch.randn((1, 16, 32), requires_grad=True)
    pos = torch.zeros((1, 16), dtype=torch.int32)
    out, aux = tt._sublayer_train(p, cfg, "rwkv", x, pos)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert float(aux) == 0.0
    (g,) = torch.autograd.grad(out.sum(), [x])
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
    with pytest.raises(ValueError, match="unknown sub-layer kind"):
        tt._sublayer_train(p, cfg, "conv", x, pos)
