"""The port's optimizers (repro_torch/optim): the cases of
tests/test_optim.py (quadratic convergence, state shapes and dtypes,
Adafactor factoring, warmup-cosine, grad clipping), and the updates
against the JAX package's over several steps on the same numpy params
and grads, with ``lr`` the constructor's, a float or a 0-d tensor.

TOL: the same float32 update in two libraries (pow, rsqrt and the
means differ in the last ulp).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.optim import (make_adafactor, make_adamw,  # noqa: E402
                               make_sgd, warmup_cosine)
from repro_torch.optim.api import tree_leaves  # noqa: E402

TOL = dict(rtol=2e-5, atol=1e-6)


def _quadratic_losses(opt, steps=200, dim=16):
    g = torch.Generator().manual_seed(0)
    target = torch.randn((dim, dim), generator=g)
    params = {"w": torch.zeros((dim, dim)), "b": torch.zeros((dim,))}
    state = opt.init(params)

    def loss_fn(p):
        return torch.mean((p["w"] - target) ** 2) + torch.mean(p["b"] ** 2)

    losses = [float(loss_fn(params))]
    for _ in range(steps):
        live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        grads = dict(zip(live, torch.autograd.grad(loss_fn(live),
                                                   list(live.values())),
                         strict=True))
        params, state = opt.update(params, grads, state)
    losses.append(float(loss_fn(params)))
    return losses


@pytest.mark.parametrize("make", [
    lambda: make_adamw(lr=3e-2, weight_decay=0.0),
    lambda: make_adafactor(lr=3e-1, min_dim_size_to_factor=8),
    lambda: make_sgd(lr=0.3, momentum=0.9),
])
def test_quadratic_convergence(make):
    losses = _quadratic_losses(make())
    assert losses[-1] < losses[0] * 1e-2, losses


def test_adamw_step_counter_and_dtypes():
    opt = make_adamw()
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state["step"].dtype == torch.int32 and list(state)[0] == "step"
    g = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    params2, state = opt.update(params, g, state)
    assert int(state["step"]) == 1
    assert params2["w"].dtype == torch.bfloat16       # cast back
    assert state["mu"]["w"].dtype == torch.float32    # f32 moments


def test_adafactor_factored_state_memory():
    opt = make_adafactor(min_dim_size_to_factor=128)
    params = {"big": torch.zeros((1024, 2048)), "small": torch.zeros((64, 64)),
              "vec": torch.zeros((4096,))}
    s = opt.init(params)["v"]
    assert set(s["big"]) == {"vr", "vc"}
    assert s["big"]["vr"].shape == (1024,) and s["big"]["vc"].shape == (2048,)
    assert set(s["small"]) == {"v"}           # below factor threshold
    assert set(s["vec"]) == {"v"}             # 1-D never factored


def test_warmup_cosine_schedule():
    sched = warmup_cosine(1.0, warmup=10, total=110, final_frac=0.1)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    assert float(sched(i32(0))) == 0.0
    assert abs(float(sched(i32(10))) - 1.0) < 1e-6
    assert abs(float(sched(i32(110))) - 0.1) < 1e-6
    assert float(sched(i32(60))) < 1.0


def test_grad_clip_bounds_update():
    opt = make_adamw(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    params = {"w": torch.zeros((8, 8))}
    params2, _ = opt.update(params, {"w": 1e6 * torch.ones((8, 8))},
                            opt.init(params))
    assert float(torch.max(torch.abs(params2["w"]))) < 1.5


def test_inplace_updates_write_into_the_given_tensors():
    opt = make_adamw(lr=1e-2)
    params = {"w": torch.ones((4, 4)), "b": torch.ones((4,))}
    state = opt.init(params)
    pure, pure_state = opt.update(params, {k: v * 0.5 for k, v in
                                           params.items()}, state)
    w, mu = params["w"], state["mu"]["w"]
    got, got_state = opt.update(params, {k: torch.full_like(v, 0.5) for k, v
                                         in params.items()}, state,
                                inplace=True)
    assert got["w"] is w and got_state["mu"]["w"] is mu
    assert torch.equal(got["w"], pure["w"])
    assert torch.equal(got_state["nu"]["b"], pure_state["nu"]["b"])


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
def _tree(rng, scale=1.0):
    return {"blocks": {"w": (rng.standard_normal((2, 160, 144)) * scale
                             ).astype(np.float32),
                       "ln": (rng.standard_normal((2, 144)) * scale
                              ).astype(np.float32)},
            "embed": (rng.standard_normal((200, 130)) * scale
                      ).astype(np.float32),
            "tail": [(rng.standard_normal((7,)) * scale).astype(np.float32)]}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


OPTS = {
    "sgd": dict(lr=0.05, momentum=0.9),
    "sgd_nesterov": dict(lr=0.05, momentum=0.9, nesterov=True),
    "sgd_plain": dict(lr=0.05, momentum=0.0),
    "adamw": dict(lr=1e-3),
    "adamw_cosine": dict(lr=1e-3),
    "adafactor": dict(lr=1e-2, weight_decay=0.01),
}


def _make(mod, name):
    kw = dict(OPTS[name])
    base = name.split("_")[0]
    if name == "adamw_cosine":
        kw["schedule"] = mod.adamw.warmup_cosine(1e-3, warmup=2, total=6)
    return getattr(mod, f"make_{base}")(**kw)


@pytest.mark.parametrize("lr", ["constructor", "float", "tensor"])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_updates_match_the_reference(name, lr):
    import jax
    import jax.numpy as jnp

    import repro.optim as jopt
    import repro_torch.optim as topt
    rng = np.random.default_rng(0)
    p_np = _tree(rng)
    jo, to = _make(jopt, name), _make(topt, name)
    jp, tp = jax.tree.map(jnp.asarray, p_np), _to_torch(p_np)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(4):
        g_np = _tree(rng, 0.1)
        kw_j, kw_t = {}, {}
        if lr == "float":
            kw_j = kw_t = dict(lr=0.003)
        elif lr == "tensor":
            kw_j, kw_t = dict(lr=jnp.float32(0.003)), dict(lr=torch.tensor(
                0.003))
        jp, js = jax.jit(lambda p, g, s: jo.update(p, g, s, **kw_j))(
            jp, jax.tree.map(jnp.asarray, g_np), js)
        tp, ts = to.update(tp, _to_torch(g_np), ts, inplace=step % 2 == 1,
                           **kw_t)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    jl = [np.asarray(x) for x in jax.tree.leaves(js)]
    tl = [x.numpy() for x in tree_leaves(ts)]
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, **TOL)


def test_adafactor_row_blocks_change_no_more_than_rounding(monkeypatch):
    """A leaf updated in many row blocks (the memory-lean path the
    full-width model takes) against the reference, as in one block."""
    from repro_torch.optim import adafactor
    monkeypatch.setattr(adafactor, "ROW_BLOCK", 1000)
    test_updates_match_the_reference("adafactor", "float")
