"""The port's capacity-routed MoE (models/mlp.py::moe, init_moe_params)
against the JAX package's: one MoE layer on the same inputs with and
without capacity drops (the capacity C, the routing gate_idx, the keep
mask, the load-balance aux loss and the output), top-k ties broken toward
the lower expert as ``jax.lax.top_k`` breaks them, and dbrx-smoke (top-2
of 4 experts) and arctic-smoke (top-2 of 8 with the dense residual MLP
and Adafactor) through forward_train, one train step, prefill, decode and
generate; the reference's weights and optimizer state carried across by
``api.convert``.

gate_idx is asserted equal wherever the router sees the same bits: the
router runs in float32 in both packages.  At bfloat16 activations the
whole models differ upstream of the router by rounding, so a token whose
k-th and (k+1)-th experts are nearly tied can flip; prefill and decode
logits still agree to BF16_REL (the test file's tolerance for every
architecture), and the loss to MOE_BF16_LOSS_RTOL: a flipped token's FFN
output moves by its smaller gate weight times the difference of two
experts' outputs (observed 3.4e-3 on dbrx-smoke and 1.1e-3 on
arctic-smoke, where the dense models agree within 2.5e-4).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import common as jcommon  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.optim import get_optimizer as jget_optimizer  # noqa: E402
from repro_torch.api.convert import (lm_params_from_reference,  # noqa: E402
                                     lm_state_from_reference)
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.optim.api import tree_leaves  # noqa: E402
from test_torch_arch import (ACTS, check_forward_train,  # noqa: E402
                             check_generate, check_prefill_and_decode,
                             check_train_step, configs, flat, numpy,
                             reference_run, rel_err, stacked, tensor)

torch.set_num_threads(1)

MOE = ("dbrx-132b", "arctic-480b")
MOE_BF16_LOSS_RTOL = 1e-2
BF16_MOE_REL = 2e-2          # one bf16 MoE layer on the same inputs


def _assert_layer_close(got, want):
    """A float32 MoE layer's output: the experts' products summed in
    other orders, relative to the layer's scale (its outputs reach ~1e2:
    the expert weights' fan-in is E, as the reference's dense_init takes
    it)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


def _layer(arch, act, capacity_factor, T_shape=(2, 24), seed=0):
    """The first block's FFN params of SMOKE ``arch`` in ``act``, and
    inputs, for both packages."""
    jc, tc = configs(arch, act, capacity_factor=capacity_factor)
    jp = jtr.init_params(jc, jax.random.PRNGKey(seed))
    ffn = jax.tree.map(lambda t: t[0], jp["blocks"])["sub0"]["ffn"]
    jdt = jcommon.dtype_of(act)
    jffn = jcommon.cast_floats(ffn, jdt)
    tffn = jax.tree.map(lambda a: tensor(np.asarray(a)), jffn)
    x = np.random.default_rng(seed + 1).standard_normal(
        T_shape + (jc.d_model,)).astype(np.float32)
    jx = jnp.asarray(x).astype(jdt)
    return jc, tc, jffn, tffn, jx, tensor(np.asarray(jx))


def _reference_routing(jc, p, jx):
    """The reference's routing, its ``moe`` lines for the router, top-k,
    capacity and keep mask (``repro/models/mlp.py:67-87``), in jnp."""
    B, S, D = jx.shape
    E, K = jc.num_experts, jc.experts_per_token
    T = B * S
    probs = jax.nn.softmax(jx.reshape(T, D).astype(jnp.float32)
                           @ p["router"], axis=-1)
    gate_w, gate_idx = jax.lax.top_k(probs, K)
    eids = gate_idx.reshape(T * K)
    onehot = jax.nn.one_hot(eids, E, dtype=jnp.int32)
    pos_in_e = (jnp.cumsum(onehot, axis=0) * onehot).sum(-1) - 1
    return np.asarray(gate_idx), np.asarray(gate_w), np.asarray(pos_in_e)


def _reference_capacity(jc, jp, jx):
    """C as the reference builds it: the middle dim of its (E, C, D)
    dispatch buffer, read from the traced program."""
    jaxpr = jax.make_jaxpr(lambda p, x: jmlp.moe(p, jc, x))(jp, jx)
    E, D = jc.num_experts, jc.d_model
    shapes = {tuple(v.aval.shape) for eqn in jaxpr.jaxpr.eqns
              for v in eqn.outvars}
    cs = {s[1] for s in shapes if len(s) == 3 and s[0] == E and s[2] == D}
    assert len(cs) == 1, cs
    return cs.pop()


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("arch", MOE)
def test_moe_layer_matches_the_reference(arch, capacity_factor, act):
    """C, gate_idx (equal), the keep mask (equal), aux and the output;
    capacity 0.5 drops assignments, 8.0 keeps every one."""
    jc, tc, jp, tp, jx, tx = _layer(arch, act, capacity_factor)
    B, S, D = tx.shape
    T = B * S
    C = tmlp.capacity(tc, T)
    assert C == _reference_capacity(jc, jp, jx)
    want_idx, want_w, pos = _reference_routing(jc, jp, jx)
    probs, gate_w, gate_idx = tmlp.route(tp, tc, tx.reshape(T, D))
    np.testing.assert_array_equal(gate_idx.numpy(), want_idx)
    np.testing.assert_allclose(gate_w.numpy(), want_w, rtol=1e-6, atol=0)
    eids, slot, keep = tmlp.slots(gate_idx, tc.num_experts, C)
    np.testing.assert_array_equal(keep.numpy(), (pos < C) & (pos >= 0))
    np.testing.assert_array_equal(slot.numpy(), np.clip(pos, 0, C - 1))
    if capacity_factor != 1.25:   # 0.5 must drop, 8.0 must keep all
        assert bool((~keep).any()) == (capacity_factor < 1.0)
    want, jaux = jmlp.moe(jp, jc, jx)
    got, aux = tmlp.moe(tp, tc, tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    if act == "float32":
        _assert_layer_close(got, want)
    else:
        assert rel_err(numpy(got), np.asarray(want, np.float32)) <= \
            BF16_MOE_REL


def test_top_k_ties_go_to_the_lower_expert():
    """Experts 1 and 3 have the same router column (and 0 and 2 the same
    as each other): every token's probabilities tie in pairs, and both
    packages take the lower index of each tied pair first."""
    jc, tc, jp, tp, jx, tx = _layer("arctic-480b", "float32", 1.25)
    router = np.array(jp["router"])
    router[:, 3] = router[:, 1]
    router[:, 2] = router[:, 0]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    T, D = tx.shape[0] * tx.shape[1], tx.shape[2]
    want, _, _ = _reference_routing(jc, jp, jx)
    probs, _, gate_idx = tmlp.route(tp, tc, tx.reshape(T, D))
    assert bool((probs[:, 1] == probs[:, 3]).all())
    np.testing.assert_array_equal(gate_idx.numpy(), want)
    ties = (probs[:, 0] == probs[:, 2]) | (probs[:, 1] == probs[:, 3])
    assert bool(ties.all())


def test_decode_capacity_drops_as_the_reference():
    """A decode step routes T = B tokens: C = max(int(1.25 * B * K / E),
    1) = 1 at dbrx-smoke's B = 2, K = 2, E = 4, so an expert that two of
    the four assignments pick drops one, in both packages."""
    jc, tc, jp, tp, jx, tx = _layer("dbrx-132b", "float32", 1.25,
                                    T_shape=(2, 1))
    assert tmlp.capacity(tc, 2) == 1 == _reference_capacity(jc, jp, jx)
    _, _, pos = _reference_routing(jc, jp, jx)
    _, _, gate_idx = tmlp.route(tp, tc, tx.reshape(2, -1))
    keep = tmlp.slots(gate_idx, tc.num_experts, 1)[2]
    np.testing.assert_array_equal(keep.numpy(), pos < 1)
    want, _ = jmlp.moe(jp, jc, jx)
    got, _ = tmlp.moe(tp, tc, tx)
    _assert_layer_close(got, want)


def test_moe_gradients_reach_router_and_experts():
    """Autograd through the dispatch: the router (through the gate
    weights and the aux loss) and every expert get gradients equal to
    jax.grad's of the same scalar."""
    jc, tc, jp, tp, jx, tx = _layer("arctic-480b", "float32", 1.25)

    def jloss(p):
        out, aux = jmlp.moe(p, jc, jx)
        return jnp.sum(out * out) + aux

    want = jax.grad(jloss)(jp)
    live = {k: v for k, v in flat(tp).items()}
    for v in live.values():
        v.requires_grad_(True)
    out, aux = tmlp.moe(tp, tc, tx)
    grads = torch.autograd.grad(torch.sum(out * out) + aux,
                                list(live.values()))
    wf = flat(want)
    for (path, _), g in zip(live.items(), grads, strict=True):
        assert float(g.abs().sum()) > 0, path
        _assert_layer_close(g, wf[path])


# ---------------------------------------------------------------------------
# the two MoE architectures end to end
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("arch", MOE)
def test_forward_train_matches_the_reference(arch, act):
    if act == "float32":
        check_forward_train(arch, act)
        return
    ref = reference_run(arch, act)
    _, tc = configs(arch, act)
    params = stacked(lm_params_from_reference(ref["params"], tc,
                                              device="cpu"))
    loss, m = ttr.forward_train(tc, params, {k: tensor(v) for k, v in
                                             ref["batch"].items()})
    np.testing.assert_allclose(float(m["loss"]), ref["metrics"]["loss"],
                               rtol=MOE_BF16_LOSS_RTOL)
    np.testing.assert_allclose(float(m["moe_aux"]),
                               ref["metrics"]["moe_aux"],
                               rtol=MOE_BF16_LOSS_RTOL)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("arch", MOE)
def test_prefill_cache_and_decode_match_the_reference(arch, act):
    check_prefill_and_decode(arch, act)


@pytest.mark.parametrize("arch", MOE)
def test_generate_tokens_equal_the_references(arch):
    check_generate(arch)


@pytest.mark.parametrize("arch", MOE)
def test_one_train_step_matches_the_reference(arch):
    """dbrx-smoke under AdamW, arctic-smoke under Adafactor (its
    config's optimizer): factored second moments of the stacked (2, E,
    d, f) expert leaves included."""
    opt = check_train_step(arch)
    assert opt.name == ("adafactor" if arch == "arctic-480b" else "adamw")


@pytest.mark.parametrize("arch", MOE)
def test_convert_carries_moe_params_and_state(arch):
    """lm_params_from_reference splits the stacked (n_full, E, d, f)
    expert leaves (and arctic's ``dense`` MLP) into per-block dicts, and
    lm_state_from_reference takes one replica of a replica-stacked
    TreeSync state: every leaf equal."""
    jc, tc = configs(arch)
    jp = jax.tree.map(np.asarray, jtr.init_params(jc,
                                                  jax.random.PRNGKey(1)))
    got = lm_params_from_reference(jp, tc, device="cpu")
    blk = got["blocks"][1]["sub0"]["ffn"]
    assert tuple(blk["w_gate"].shape) == (tc.num_experts, tc.d_model,
                                          tc.d_ff)
    assert ("dense" in blk) == bool(tc.moe_dense_ff)
    g, w = flat(stacked(got)), flat(jp)
    assert sorted(g) == sorted(w)
    for path in w:
        np.testing.assert_array_equal(numpy(g[path]),
                                      np.asarray(w[path], np.float32))
    jopt = jget_optimizer(jc)
    two = lambda t: np.stack([np.asarray(t), 2 * np.asarray(t)])  # noqa: E731
    state = {"params": jax.tree.map(two, jp),
             "opt_state": jax.tree.map(two, jax.tree.map(
                 np.asarray, jopt.init(jax.tree.map(jnp.asarray, jp)))),
             "step": np.int32(3), "residual": None}
    st = lm_state_from_reference(state, replica=1, device="cpu")
    assert st.step == 3 and st.residual is None
    for a, b in zip(tree_leaves(st.params), jax.tree.leaves(jp),
                    strict=True):
        np.testing.assert_array_equal(numpy(a), 2 * np.asarray(b,
                                                                np.float32))
    assert len(tree_leaves(st.opt_state)) == len(jax.tree.leaves(
        state["opt_state"]))


def test_init_moe_params_is_the_references_layout():
    """Five keys in the reference's order; the router float32 whatever
    the parameter dtype."""
    jc, tc = configs("dbrx-132b", param_dtype="bfloat16")
    want = jmlp.init_moe_params(jax.random.PRNGKey(2), jc, jnp.bfloat16)
    got = tmlp.init_moe_params(prng.PRNGKey(2), tc, torch.bfloat16,
                               device="cpu")
    assert sorted(got) == sorted(want)
    assert got["router"].dtype == torch.float32
    for k in want:
        assert str(got[k].dtype) == f"torch.{want[k].dtype}"
        np.testing.assert_allclose(numpy(got[k]),
                                   np.asarray(want[k], np.float32),
                                   rtol=2.0 ** -7, atol=1e-6)
