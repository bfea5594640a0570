"""The port's plan IR (repro_torch.core.engine.plan) against the JAX
package's on tests/test_engine.py's trees: every TreePlan array field,
the fingerprint, the key and index replays and the runtime masks are
integer-exact (or bit-equal float32)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.engine import plan as jplan  # noqa: E402
from repro_torch.core import tree as ttree  # noqa: E402
from repro_torch.core.engine import plan as tplan  # noqa: E402
from test_engine import CASES  # noqa: E402

torch.set_num_threads(1)


def to_port(node) -> ttree.TreeNode:
    """The same tree as the port's TreeNode (the records share fields)."""
    fields = {f.name: getattr(node, f.name)
              for f in dataclasses.fields(node) if f.name != "children"}
    return ttree.TreeNode(children=tuple(to_port(c) for c in node.children),
                          **fields)


def _key(seed):
    k = jax.random.PRNGKey(seed)
    return k, np.asarray(k)


@pytest.mark.parametrize("weighting", ["uniform", "size"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_fields_and_fingerprint_match(case, weighting):
    tree = CASES[case]()
    a = jplan.compile_tree(tree, weighting=weighting)
    b = tplan.compile_tree(to_port(tree), weighting=weighting)
    for name in jplan.FINGERPRINT_ARRAY_FIELDS + ("root_sync",):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(y, x, err_msg=name)
    for name in jplan.FINGERPRINT_SCALAR_FIELDS + ("n_children",
                                                    "leaf_names"):
        assert getattr(b, name) == getattr(a, name), name
    assert (a.levels is None) == (b.levels is None)
    if a.levels is not None:
        assert [dataclasses.astuple(lv) for lv in b.levels] == \
            [dataclasses.astuple(lv) for lv in a.levels]
    assert b.fingerprint == a.fingerprint


@pytest.mark.parametrize("case", sorted(CASES))
def test_key_and_index_plans_match(case):
    tree = CASES[case]()
    a, b = jplan.compile_tree(tree), tplan.compile_tree(to_port(tree))
    kj, kn = _key(5)
    np.testing.assert_array_equal(tplan.key_plan(to_port(tree), b, kn),
                                  jplan.key_plan(tree, a, kj))
    np.testing.assert_array_equal(tplan.index_plan(to_port(tree), b, kn),
                                  jplan.index_plan(tree, a, kj))
    np.testing.assert_array_equal(
        tplan.index_plan(to_port(tree), b, kn, local_h=7),
        jplan.index_plan(tree, a, kj, local_h=7))


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_key_plan_and_root_chain_match(case):
    chunk = dataclasses.replace(CASES[case](), rounds=1)
    a, b = jplan.compile_tree(chunk), tplan.compile_tree(to_port(chunk))
    kj, kn = _key(3)
    np.testing.assert_array_equal(
        tplan.chunked_key_plan(to_port(chunk), b, kn, 3),
        jplan.chunked_key_plan(chunk, a, kj, 3))
    assert tplan.chunked_key_plan(to_port(chunk), b, kn, 0).shape == \
        (0, b.n_ticks, b.n_leaves, 2)
    K = len(chunk.children)
    np.testing.assert_array_equal(
        tplan.advance_root_key(kn, 4, K).numpy(),
        np.asarray(jplan.advance_root_key(kj, 4, K)).astype(np.int64))


def test_runtime_masks_match():
    tree = CASES["imbalanced"]()
    a, b = jplan.compile_tree(tree), tplan.compile_tree(to_port(tree))
    np.testing.assert_array_equal(tplan.full_participation(b),
                                  jplan.full_participation(a))
    np.testing.assert_array_equal(tplan.full_steps(b), jplan.full_steps(a))
    for h in (7, [5, 60, 3, 20, 25], np.arange(a.n_ticks * 5).reshape(
            a.n_ticks, 5) % 31):
        np.testing.assert_array_equal(tplan.steps_for_h(b, h),
                                      jplan.steps_for_h(a, h))


def _compressed_variants(tree):
    """(tree, compression) pairs: level defaults (one spec, a per-depth
    list with a gap), and per-edge up_compress overrides beating them."""
    D = tree.depth()
    first = tree.children[0]
    edge = dataclasses.replace(tree, children=(dataclasses.replace(
        first, up_compress="topk_0.2"),) + tree.children[1:])
    yield tree, "int8"
    yield tree, "topk_0.25"
    yield tree, ["topk_0.5"] + [None] * (D - 1)
    yield tree, ["int8"] * (D - 1) + ["topk"]
    yield edge, None
    yield edge, "int8"


def test_compression_is_refused_until_ported():
    """Compressed plans are no longer refused (the test keeps its name):
    on every engine tree, level defaults, per-depth lists and per-edge
    up_compress overrides give the reference's compress_kind /
    compress_frac, fingerprint and plan_bytes_per_round, and "none" is
    the uncompressed plan."""
    for case in sorted(CASES):
        tree = CASES[case]()
        plain = tplan.compile_tree(to_port(tree))
        none = tplan.compile_tree(to_port(tree), compression="none")
        assert not none.has_compression
        assert none.fingerprint == plain.fingerprint
        for variant, comp in _compressed_variants(tree):
            a = jplan.compile_tree(variant, compression=comp)
            b = tplan.compile_tree(to_port(variant), compression=comp)
            assert a.has_compression and b.has_compression
            for name in ("compress_kind", "compress_frac"):
                x, y = getattr(a, name), getattr(b, name)
                assert x.dtype == y.dtype, name
                np.testing.assert_array_equal(y, x, err_msg=name)
            assert b.fingerprint == a.fingerprint != plain.fingerprint
            for d in (24, 33, 512):
                assert tplan.plan_bytes_per_round(b, d) == \
                    jplan.plan_bytes_per_round(a, d)
                assert tplan.plan_bytes_per_round(b, d, dtype_bytes=2) == \
                    jplan.plan_bytes_per_round(a, d, dtype_bytes=2)
        with pytest.raises(ValueError, match="internal depths"):
            tplan.compile_tree(to_port(tree),
                               compression=["int8"] * (tree.depth() + 1))
        with pytest.raises(ValueError):
            tplan.compile_tree(to_port(tree), compression="gzip")
