"""Property-based tests (hypothesis) of the port's invariants, those of the
JAX package's tests/test_properties.py: weak duality, a dual that never
decreases under LocalSDCA, the closed-form coordinate step as the scalar
maximizer, the eq. (11)/(12) bound as a contraction and H* monotone in the
delay, eq. (9) star time, tree-time additivity, the int8 error bound,
top-k keeping the largest, and the ring wire formulas
(launch/roofline.py; the reference's HLO readers have no counterpart).
Inputs are drawn with numpy from hypothesis' seeds, float32 as the
reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core import compression as comp  # noqa: E402
from repro_torch.core import dual as dual_mod  # noqa: E402
from repro_torch.core.delay import (log_bound, optimal_h,  # noqa: E402
                                    per_round_factor, rounds_for_budget)
from repro_torch.core.local_sdca import local_sdca  # noqa: E402
from repro_torch.core.prng import PRNGKey  # noqa: E402
from repro_torch.core.tree import star, two_level  # noqa: E402
from repro_torch.launch.roofline import (CollectiveOp,  # noqa: E402
                                         collective_summary)

SETTINGS = settings(max_examples=25, deadline=None)


def _normal(seed, *shape):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


# ---------------------------------------------------------------------------
# duality invariants
# ---------------------------------------------------------------------------
@SETTINGS
@given(st.integers(4, 24), st.integers(2, 8),
       st.floats(0.01, 1.0), st.integers(0, 10_000))
def test_weak_duality_squared(m, d, lam, seed):
    """P(w(alpha)) >= D(alpha) for any alpha (weak duality)."""
    X, y, alpha = _normal(seed, m, d), _normal(seed + 1, m), \
        _normal(seed + 2, m)
    gap = float(dual_mod.duality_gap(alpha, X, y, dual_mod.get_loss(
        "squared"), lam))
    assert gap >= -1e-4, gap


@SETTINGS
@given(st.integers(8, 32), st.integers(2, 8), st.floats(0.05, 1.0),
       st.integers(0, 10_000), st.integers(1, 64))
def test_sdca_never_decreases_dual(m, d, lam, seed, steps):
    """Every LocalSDCA step is an exact scalar maximization => the dual
    objective is nondecreasing, and dw stays A @ da."""
    X, y = _normal(seed, m, d), _normal(seed + 1, m)
    loss = dual_mod.get_loss("squared")
    alpha, w = torch.zeros(m), torch.zeros(d)
    d0 = float(dual_mod.dual_value(alpha, X, y, loss, lam))
    da, dw = local_sdca(X, y, alpha, w, PRNGKey(seed), loss=loss, lam=lam,
                        m_total=m, num_steps=steps)
    d1 = float(dual_mod.dual_value(alpha + da, X, y, loss, lam))
    assert d1 >= d0 - 1e-6, (d0, d1)
    np.testing.assert_allclose((w + dw).numpy(),
                               dual_mod.w_of_alpha(alpha + da, X, lam).numpy(),
                               rtol=1e-4, atol=1e-5)


@SETTINGS
@given(st.sampled_from(["squared", "smooth_hinge_1", "logistic"]),
       st.integers(0, 1000))
def test_coord_delta_is_argmax(loss_name, seed):
    """The closed-form coordinate delta maximizes the scalar dual: no
    nearby delta does better."""
    loss = dual_mod.get_loss(loss_name)
    rng = np.random.default_rng(seed)
    wx = float(rng.standard_normal())
    y = (float(np.sign(rng.standard_normal()) or 1.0)
         if loss_name != "squared" else float(rng.standard_normal()))
    alpha = float(rng.uniform(0.1, 0.9)) * (y if loss_name != "squared"
                                            else 1.0)
    xsq = float(rng.uniform(0.1, 2.0))
    t = torch.tensor

    def scalar_dual(delta):
        return (-0.5 * xsq * delta ** 2 - wx * delta
                - float(loss.conj_neg(t(alpha + delta), t(y))))

    d_star = float(loss.coord_delta(t(wx), t(alpha), t(y), t(xsq)))
    f_star = scalar_dual(d_star)
    for eps in (-0.05, -0.01, 0.01, 0.05):
        trial = d_star + eps
        if loss_name != "squared" and not 0.0 <= (alpha + trial) * y <= 1.0:
            continue  # outside the dual-feasible set
        assert f_star >= scalar_dual(trial) - 1e-5


# ---------------------------------------------------------------------------
# delay model invariants (paper §6)
# ---------------------------------------------------------------------------
@SETTINGS
@given(st.floats(0.1, 0.9), st.integers(2, 16), st.floats(1e-4, 0.1),
       st.floats(1e-6, 1e-3), st.floats(0.0, 1.0))
def test_bound_is_valid_rate(C, K, delta, t_lp, t_delay):
    """g(H) in (0, 1] and T > 0 => log bound <= 0 (contraction)."""
    g = per_round_factor(16, C, K, delta)
    assert 0.0 < g <= 1.0
    lb = log_bound(16, C=C, K=K, delta=delta, t_total=1.0, t_lp=t_lp,
                   t_delay=t_delay, t_cp=0.0)
    assert lb <= 0.0
    assert rounds_for_budget(1.0, 16, t_lp, t_delay, 0.0) > 0


@SETTINGS
@given(st.floats(0.0, 1e3), st.floats(1.5, 10.0))
def test_optimal_h_monotone_in_delay(r, factor):
    """Paper Fig. 4(b): H*(r2) >= H*(r1) for r2 > r1."""
    kw = dict(C=0.5, K=3, delta=1 / 300, t_total=1.0, t_lp=4e-5, t_cp=3e-5,
              h_max=10 ** 5)
    h1, _ = optimal_h(t_delay=r * 4e-5, **kw)
    h2, _ = optimal_h(t_delay=r * factor * 4e-5 + 1e-6, **kw)
    assert h2 >= h1


# ---------------------------------------------------------------------------
# tree timing invariants
# ---------------------------------------------------------------------------
@SETTINGS
@given(st.integers(2, 8), st.integers(1, 64), st.floats(0, 1e-2),
       st.integers(1, 8))
def test_star_time_matches_eq9(K, H, t_delay, T):
    """star solve_time == eq. (9): (t_lp H + t_delay + t_cp) * T."""
    t_lp, t_cp = 1e-5, 3e-5
    tree = star(K, 10, outer_rounds=T, local_steps=H, t_lp=t_lp,
                t_cp=t_cp, t_delay=t_delay)
    assert abs(tree.solve_time() - (t_lp * H + t_delay + t_cp) * T) < 1e-12


@SETTINGS
@given(st.integers(2, 4), st.integers(1, 4), st.integers(1, 4),
       st.integers(1, 4))
def test_tree_time_additivity(groups, wpg, gr, rr):
    """Two-level tree time = root rounds x (group phase + root link)."""
    tree = two_level(groups, wpg, 10, root_rounds=rr, group_rounds=gr,
                     local_steps=16, t_lp=1e-5, root_delay=1e-3,
                     group_delay=1e-5)
    per_root_round = gr * (16 * 1e-5 + 1e-5) + 1e-3
    assert abs(tree.solve_time() - rr * per_root_round) < 1e-9


# ---------------------------------------------------------------------------
# compression invariants
# ---------------------------------------------------------------------------
@SETTINGS
@given(st.integers(1, 2048), st.integers(0, 10_000))
def test_int8_quant_bounded_error(n, seed):
    x = _normal(seed, n)
    codes, scale = comp.quantize_int8(x)
    back = comp.dequantize_int8(codes, scale, x.shape, x.dtype)
    # per-block absmax scaling: error <= scale/2 <= blockmax/254
    assert float((back - x).abs().max()) <= \
        float(x.abs().max()) / 254.0 + 1e-7


@SETTINGS
@given(st.integers(2, 512), st.floats(0.01, 1.0), st.integers(0, 1000))
def test_topk_preserves_largest(n, frac, seed):
    x = _normal(seed, n)
    vals, _ = comp.topk_sparsify(x, frac)
    k = max(int(n * frac), 1)
    thresh = np.sort(np.abs(x.numpy()))[-k]
    assert np.all(np.abs(vals.numpy()) >= thresh - 1e-6)


# ---------------------------------------------------------------------------
# wire formulas
# ---------------------------------------------------------------------------
@SETTINGS
@given(st.sampled_from([torch.float32, torch.bfloat16, torch.int32]),
       st.integers(1, 64), st.integers(1, 64), st.integers(2, 64))
def test_wire_formulas(dtype, a, b, n):
    nbytes = a * b * torch.empty((), dtype=dtype).element_size()
    ar = CollectiveOp("all-reduce", nbytes, n)
    ag = CollectiveOp("all-gather", nbytes, n)
    rs = CollectiveOp("reduce-scatter", nbytes // n, n)
    # all-reduce == reduce-scatter + all-gather on the same payload
    assert abs(ar.wire_bytes_per_chip() - 2 * ag.wire_bytes_per_chip()) \
        < 1e-9
    assert rs.wire_bytes_per_chip() == (n - 1) * (nbytes // n)
    s = collective_summary([ar, ag])
    assert s["n_ops"] == 2 and s["result_bytes"] == 2 * nbytes
