"""Model init from threefry keys (models/*.py, core/prng.py): the port's
``init_params(cfg, key)`` against ``jax.jit(repro.models.transformer.
init_params)`` from the same key, at SMOKE recurrentgemma-2b and the tiny
dense config of the LM session tests.

The tree layout (names, shapes, dtypes) must be the reference's exactly
and every leaf within ULPS float32 ulp of the reference's: the uniforms
under each normal are the reference's bit for bit, and erfinv is XLA's
polynomial with its fused multiply-adds (``core/prng.py::erfinv``); only
``log1p`` is torch's.  The keys themselves (``split_keys``) match bit for
bit, and the blocked draw equals the whole draw.
"""
import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import recurrentgemma_2b as jrg  # noqa: E402
from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.configs import recurrentgemma_2b as trg  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import treesync as tsy  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.optim import make_adafactor, make_adamw  # noqa: E402

ULPS = 4
TINY = dict(name="tiny", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64,
            vocab_size=64, q_chunk_size=16, logits_chunk=16, remat=False,
            activation_dtype="float32")
CONFIGS = {"recurrentgemma-2b-smoke": (jrg.SMOKE, trg.SMOKE),
           "tiny-dense": (JConfig(**TINY), ModelConfig(**TINY))}


def _flat(tree, path=""):
    """{path: leaf} of a nested dict / list tree."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}[{i}]"))
        return out
    return {path: tree}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().float().numpy() \
            if t.dtype == torch.bfloat16 else t.detach().cpu().numpy()
    return np.asarray(t)


def _ulps(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| in float32 ulps of the larger magnitude."""
    if got.size == 0:
        return 0.0
    g, w = got.astype(np.float64), want.astype(np.float64)
    ulp = np.spacing(np.maximum(np.abs(g), np.abs(w)).astype(np.float32))
    return float(np.max(np.abs(g - w) / np.maximum(ulp.astype(np.float64),
                                                   np.finfo(np.float32).tiny)))


def _stacked_port(params):
    """The port's per-block list as the reference's stacked blocks."""
    return ttr.stack_blocks(params)


def _assert_same_tree(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for path in g:
        a, b = _np(g[path]), _np(w[path])
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (path, a.shape, b.shape, a.dtype, b.dtype)
        assert _ulps(a, b) <= ULPS, (path, _ulps(a, b))


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_params_is_the_references_within_ulps(name, seed):
    jcfg, tcfg = CONFIGS[name]
    want = jax.jit(lambda k: jtr.init_params(jcfg, k))(
        jax.random.PRNGKey(seed))
    got = ttr.init_params(tcfg, prng.PRNGKey(seed), device="cpu")
    _assert_same_tree(_stacked_port(got), want)
    # a jax key's two words are a key too
    again = ttr.init_params(tcfg, np.asarray(jax.random.PRNGKey(seed)),
                            device="cpu")
    for a, b in zip(_flat(got).values(), _flat(again).values(), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [2, 3, 4, 6])
def test_split_keys_are_the_references_bit_for_bit(n):
    key = jax.random.PRNGKey(11)
    want = np.stack([np.asarray(k) for k in jcommon.split_keys(key, n)])
    got = tcommon.split_keys(prng.PRNGKey(11), n)
    assert isinstance(got, list) and len(got) == n
    np.testing.assert_array_equal(torch.stack(got).numpy(),
                                  want.astype(np.int64))


def test_dense_init_is_the_references_within_ulps():
    key = jax.random.PRNGKey(2)
    want = np.asarray(jcommon.dense_init(key, (48, 40), jnp.float32))
    got = tcommon.dense_init(prng.PRNGKey(2), (48, 40), torch.float32)
    assert _ulps(got.numpy(), want) <= ULPS
    want = np.asarray(jcommon.dense_init(key, (4, 40), jnp.float32,
                                         scale=0.1))
    got = tcommon.dense_init(prng.PRNGKey(2), (4, 40), torch.float32,
                             scale=0.1)
    assert _ulps(got.numpy(), want) <= ULPS


@pytest.mark.parametrize("shape,block", [((10, 7), 28), ((3, 50), 20),
                                         ((25,), 8)])
def test_blocked_normal_is_the_whole_draw(shape, block):
    """Row blocks (three or more here, one row each when a row is longer
    than a block) from the counters of the whole draw: torch.equal."""
    key = prng.PRNGKey(9)
    whole = prng.normal(key, shape)
    got = prng.normal_blocked(key, shape, block_elems=block)
    rows = max(1, block // int(np.prod(shape[1:], dtype=np.int64)))
    assert -(-shape[0] // rows) >= 3
    assert torch.equal(got, whole)
    scaled = prng.normal_blocked(key, shape, dtype=torch.bfloat16,
                                 scale=0.02, block_elems=block)
    assert torch.equal(scaled, (whole * 0.02).to(torch.bfloat16))


def test_erfinv_is_xlas_within_two_ulps():
    """XLA's erfinv polynomial with its multiply-adds: within 2 ulp of
    jax.lax.erf_inv over a million uniforms and the interval's edges,
    where torch.erfinv is off by tens of ulps in the tails."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = prng.uniform(prng.PRNGKey(4), (1 << 20,), lo, 1.0)
    edges = torch.tensor([lo, -0.5, 0.0, 1e-30, 0.9999999, -1.0, 1.0])
    u = torch.cat([u, edges])
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(u.numpy())))
    got = prng.erfinv(u).numpy()
    finite = np.isfinite(want)
    assert np.array_equal(got[~finite], want[~finite])
    assert _ulps(got[finite], want[finite]) <= 2


def test_lm_session_init_state_is_the_references():
    """LMSession.init_state() (PRNGKey(problem.seed)) and init_state(
    seed=3) against the reference's on a one-device host mesh: params and
    the optimizer's initial state within ULPS, the layout exactly."""
    from repro.api import Problem as JProblem
    from repro.api import Session as JSession
    from repro.api import Topology as JTopology
    from repro.launch.mesh import make_host_mesh as jmesh
    from repro.optim import make_adamw as jadamw
    from repro_torch.api import Problem, Session, Topology
    from repro_torch.launch.mesh import make_host_mesh
    jm = jmesh()
    jsess = JSession.compile(
        JProblem.lm(JConfig(**TINY), jadamw(), batch=4, seq=16, seed=2),
        JTopology.from_mesh(jm, sync_axes=("data",), periods=(2,)),
        backend="mesh", mesh=jm)
    tm = make_host_mesh(device_type="cpu")
    sess = Session.compile(
        Problem.lm(ModelConfig(**TINY), make_adamw(), batch=4, seq=16,
                   seed=2),
        Topology.from_mesh(tm, sync_axes=("data",), periods=(2,)),
        backend="mesh", mesh=tm, device="cpu")
    for kw in ({}, {"seed": 3}):
        want = jsess.init_state(**kw)
        got = sess.init_state(**kw)
        unstack = jax.tree.map(lambda t: np.asarray(t)[0], want.params)
        _assert_same_tree(got.params, unstack)
        opt = jax.tree.map(lambda t: np.asarray(t)[0], want.opt_state)
        _assert_same_tree(got.opt_state, opt)
    # a key and the same seed give the same state
    a = sess.init_state(prng.PRNGKey(3))
    b = sess.init_state(seed=3)
    for x, y in zip(_flat(a.params).values(), _flat(b.params).values(),
                    strict=True):
        assert torch.equal(x, y)


def test_treesync_init_state_lands_on_the_requested_device():
    """A seeded TreeSync state is built on the device asked for (the
    card by default), not on the CPU: on the meta device here, every leaf
    is there."""
    mesh = type("M", (), {"mesh_dim_names": ("data",), "shape": (1,)})()
    ts = tsy.TreeSyncConfig(sync_axes=("data",), periods=(2,))
    assert inspect.signature(tsy.init_state).parameters[
        "device"].default == "cuda"
    cfg = dataclasses.replace(ModelConfig(**TINY), num_layers=3)
    st = tsy.init_state(cfg, make_adafactor(), 7, mesh, ts, device="meta")
    leaves = list(_flat(st.params).values()) + [
        t for t in _flat(st.opt_state).values()
        if isinstance(t, torch.Tensor)]
    assert leaves and all(t.device.type == "meta" for t in leaves)
    on_cpu = tsy.init_state(cfg, make_adafactor(), 7, mesh, ts,
                            device="cpu")
    want = ttr.init_params(cfg, prng.PRNGKey(7), device="cpu")
    for a, b in zip(_flat(on_cpu.params).values(),
                    _flat(_stacked_port(want)).values(), strict=True):
        assert torch.equal(a, b)


def test_init_params_takes_a_key_or_a_seed_and_defaults_to_the_card():
    """An int is a seed (``PRNGKey(seed)``); a key is required; there is
    no other source of weights; the weights land on the card unless the
    caller asks for another device."""
    cfg = ModelConfig(**TINY)
    by_seed = ttr.init_params(cfg, 5, device="cpu")
    by_key = ttr.init_params(cfg, prng.PRNGKey(5), device="cpu")
    assert all(t.device.type == "cpu" for t in _flat(by_seed).values())
    for a, b in zip(_flat(by_seed).values(), _flat(by_key).values(),
                    strict=True):
        assert torch.equal(a, b)
    with pytest.raises(TypeError):
        ttr.init_params(cfg, device="cpu")
    params = inspect.signature(ttr.init_params).parameters
    assert list(params) == ["cfg", "key", "device"]
    assert params["device"].default == "cuda"
