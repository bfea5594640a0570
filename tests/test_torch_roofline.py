"""The port's cost tooling against the JAX package's and the numbers the
records keep: launch/hw.py, launch/roofline.py, the kernels' ``cost()``
formulas and their counting route on ``meta`` inputs, the counting comm's
links, and the dry-run CLI on one full-size cell.

  * ``CollectiveOp.wire_bytes_per_chip``, ``collective_summary`` and
    ``model_flops`` equal the reference's for every op, every
    architecture of the registry and every shape of ``SHAPES``;
  * ``roofline()`` given a namespace of the reference's TPU v5e constants
    (both link rates at its ICI rate) equals the reference's key by key;
  * each kernel's ``cost()`` gives the flops and bytes behind PERF.md's
    kernel table (2.577e11 flops at the serving shape, 503,398,400 B for
    the scan) and the bounds it prints, at the data sheet's H100 rates
    ``chip_smoke.py`` has always used;
  * a kernel wrapper on meta inputs records the launch by shape and its
    cost, returns empty outputs of the right shape, and launches nothing.
"""
import json
import types

import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as ref_registry  # noqa: E402
from repro.configs import shapes as ref_shapes  # noqa: E402
from repro.launch import hw as ref_hw  # noqa: E402
from repro.launch import roofline as ref_rf  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.core.dual import get_loss  # noqa: E402
from repro_torch.kernels import counting  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.rglru import kernel as rk  # noqa: E402
from repro_torch.kernels.rglru import ops as rg  # noqa: E402
from repro_torch.kernels.sdca import kernel as sk  # noqa: E402
from repro_torch.kernels.sdca import ops as so  # noqa: E402
from repro_torch.launch import dryrun, hw  # noqa: E402
from repro_torch.launch import roofline as rf  # noqa: E402
from repro_torch.launch.mesh import make_abstract_mesh  # noqa: E402
from repro_torch.models.shardctx import ShardContext  # noqa: E402

OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute", "ragged-all-to-all")
V5E = types.SimpleNamespace(PEAK_FLOPS_BF16=ref_hw.PEAK_FLOPS_BF16,
                            HBM_BW=ref_hw.HBM_BW, NVLINK_BW=ref_hw.ICI_BW,
                            NETWORK_BW=ref_hw.ICI_BW)


def _ms(seconds):
    return round(seconds * 1e3, 4)


@pytest.mark.parametrize("op", OPS)
def test_wire_bytes_equal_the_references(op):
    for n in (1, 2, 3, 16, 256):
        for b in (0, 4, 1000, 2 ** 31 + 12):
            got = rf.CollectiveOp(op, b, n).wire_bytes_per_chip()
            assert got == ref_rf.CollectiveOp(op, b, n).wire_bytes_per_chip()


def test_collective_summary_equals_the_references():
    spec = [(op, 1000 * (i + 1), 2 + i % 5, 1 + i % 3)
            for i, op in enumerate(OPS * 3)]
    got = rf.collective_summary([rf.CollectiveOp(*s) for s in spec])
    want = ref_rf.collective_summary([ref_rf.CollectiveOp(*s) for s in spec])
    assert got == want
    # with links: the same keys plus each link's wire bytes
    links = ["nvlink", "network"] * (len(spec) // 2)
    both = rf.collective_summary([rf.CollectiveOp(*s) for s in spec], links)
    assert {k: v for k, v in both.items() if k != "by_link"} == want
    assert sum(both["by_link"].values()) == pytest.approx(
        want["wire_bytes_per_chip"], rel=1e-12)


@pytest.mark.parametrize("arch", list(registry.ARCHS))
def test_model_flops_equal_the_references(arch):
    for name, shape in SHAPES.items():
        assert rf.model_flops(registry.get_config(arch), shape) == \
            ref_rf.model_flops(ref_registry.get_config(arch),
                               ref_shapes.SHAPES[name])


@pytest.mark.parametrize("cost,wire,n,mflops", [
    ({"flops": 3.2e14, "bytes accessed": 1.1e11}, 4.0e9, 256, 6e16),
    ({"flops": 1e10, "bytes accessed": 5e12}, 0.0, 512, 1e12),
    ({"flops": 0.0, "bytes accessed": 0.0}, 7e10, 1, 0.0),
    ({"flops": 8e15}, 1e8, 16, 2e17),
])
def test_roofline_on_the_references_constants_equals_the_references(
        cost, wire, n, mflops):
    ops = [ref_rf.CollectiveOp("all-reduce", int(wire), 2)] if wire else []
    csum = ref_rf.collective_summary(ops)
    want = ref_rf.roofline(cost, csum, n, mflops)
    got = rf.roofline(cost, csum, n, mflops, hw=V5E)
    assert got == want


def test_roofline_prices_flops_by_dtype():
    cost = {"flops": 3e12, "bytes accessed": 0.0,
            "flops by dtype": {"bfloat16": 2e12, "float32": 1e12}}
    r = rf.roofline(cost, {"wire_bytes_per_chip": 0.0}, 1, 1e12)
    assert r["compute_s"] == pytest.approx(
        2e12 / hw.PEAK_FLOPS_BF16 + 1e12 / hw.PEAK_FLOPS_F32, rel=1e-12)
    assert r["hlo_flops"] == 3e12
    assert rf.mfu(989e12, 2.0) == pytest.approx(0.5)


def test_count_step_keeps_flops_by_dtype():
    from repro_torch.launch.lowered import count_step
    meta = dict(device="meta")

    def step(a, b, c):
        return a @ b, c @ c, rg.rglru_scan(c[None], c[None])[0]

    low = count_step(step, (
        torch.empty(8, 16, dtype=torch.bfloat16, **meta),
        torch.empty(16, 4, dtype=torch.bfloat16, **meta),
        torch.empty(32, 32, **meta)))
    scan_f, _ = rg.cost(1, 32, 32)
    assert low.flops_by_dtype == {"bfloat16": 2 * 8 * 16 * 4,
                                  "float32": 2 * 32 ** 3 + scan_f}
    assert low.cost_analysis()["flops by dtype"] == {
        k: float(v) for k, v in low.flops_by_dtype.items()}
    assert low.flops == sum(low.flops_by_dtype.values())


def _written(fn, *shapes, dtype=torch.float32):
    from repro_torch.launch.lowered import OpBytes
    ts = [torch.empty(s, dtype=dtype, device="meta") if isinstance(s, tuple)
          else s for s in shapes]
    with OpBytes(known=()) as ob:
        fn(*ts)
    return ob.bytes


@pytest.mark.parametrize("name", ["index_put_", "index_copy_",
                                  "index_add_", "scatter_add_"])
def test_indexed_in_place_writes_move_their_slice(name):
    """A write of 10 rows into a 1000-row destination moves the rows, the
    index and the source, not the destination (twice the rows where it
    accumulates)."""
    idx = torch.empty(10, dtype=torch.int64, device="meta")
    row = 8 * 4
    if name == "index_put_":
        def put(d, v):
            d[:, idx] = v                       # aten.index_put_
        got = _written(put, (4, 1000, 8), (4, 10, 8))
        assert got == 10 * 8 + 2 * 4 * 10 * row
    elif name == "scatter_add_":
        ix = torch.empty(10, 8, dtype=torch.int64, device="meta")
        got = _written(lambda d, v: d.scatter_add_(0, ix, v),
                       (1000, 8), (10, 8))
        assert got == 10 * 8 * 8 + 10 * row + 2 * 10 * row
    else:
        got = _written(lambda d, v: getattr(d, name)(0, idx, v),
                       (1000, 8), (10, 8))
        n = 2 if name == "index_add_" else 1
        assert got == 10 * 8 + 10 * row + n * 10 * row


def test_roofline_prices_each_link():
    ops = [rf.CollectiveOp("all-reduce", 10 ** 9, 8),
           rf.CollectiveOp("all-gather", 10 ** 9, 16)]
    csum = rf.collective_summary(ops, ["nvlink", "network"])
    r = rf.roofline({"flops": 0.0, "bytes accessed": 0.0}, csum, 16, 0.0)
    assert r["collective_s"] == pytest.approx(
        ops[0].wire_bytes_per_chip() / hw.NVLINK_BW
        + ops[1].wire_bytes_per_chip() / hw.NETWORK_BW, rel=1e-12)
    assert r["dominant"] == "collective_s"


def test_h100_constants_keep_chip_smokes_bounds():
    assert (hw.HBM_BW, hw.PEAK_FLOPS_F32, hw.PEAK_FLOPS_BF16) == \
        (3.35e12, 67e12, 989e12)
    assert hw.GPUS_PER_NODE == 8 and hw.HBM_PER_CHIP == 80 * 2 ** 30


@pytest.mark.parametrize("shape,window,flops,bound_ms", [
    ((4, 4096, 4096, 10, 1, 256), 2048, 2.577e11, 0.2606),  # serving
    ((4, 4096, 4096, 5, 1, 256), 2048, 1.289e11, 0.1303),   # TP local
    ((4, 4096, 4096, 24, 4, 128), None, 4.124e11, 0.4170),  # dbrx EP local
    ((4, 4096, 4096, 32, 8, 80), 4096, None, 0.3475),       # h2o-danube
    ((4, 4096, 4096, 48, 8, 128), None, None, 0.8340),      # dbrx
])
def test_flash_cost_gives_the_kernel_tables_bounds(shape, window, flops,
                                                   bound_ms):
    f, b = fa.cost(*shape, window=window)
    if flops is not None:
        assert float(f"{f:.4g}") == flops
    t_ops, t_bytes = f / hw.PEAK_FLOPS_BF16, b / hw.HBM_BW
    assert t_ops > t_bytes                       # bound by operations
    assert _ms(max(t_ops, t_bytes)) == bound_ms


def test_flash_visible_pairs_match_chip_smokes_band_count():
    for S, win in ((4096, 2048), (300, 7), (64, None)):
        want = sum(min(i + 1, win or S) for i in range(S))
        assert fk.visible_pairs(S, S, window=win) == want
    # a query offset (decode-like suffix) and no mask
    assert fk.visible_pairs(2, 5, seq_offset=3) == 4 + 5
    assert fk.visible_pairs(3, 4, causal=False) == 12


@pytest.mark.parametrize("shape,nbytes,bound_ms", [
    ((4, 4096, 2560), 503_398_400, 0.1503),      # the serving shape
    ((4, 4096, 1280), 251_699_200, 0.0751),      # the TP local shape
    ((1, 2048, 2560), None, 0.0188),             # the training shape
])
def test_scan_cost_gives_the_kernel_tables_bounds(shape, nbytes, bound_ms):
    f, b = rg.cost(*shape)
    if nbytes is not None:
        assert b == nbytes
    B, S, W = shape
    assert f == 2 * B * S * W
    assert _ms(max(f / hw.PEAK_FLOPS_F32, b / hw.HBM_BW)) == bound_ms


def test_sdca_cost_is_chip_smokes_two_formulas():
    """phase 4's one-config bound and phase 3c's batched bound are the
    one formula (rows: distinct sampled rows summed over leaves)."""
    K, m_b, d, H, rows = 128, 8192, 512, 8192, 664_191
    f, b = so.cost(rows, 1, K, m_b, d, H)
    assert b == rows * d * 4 + K * (4 * m_b + 2 * d) * 4 + K * H * 8
    assert f == 4 * K * H * d
    B = 8
    f, b = sk.cost(rows, B, K, m_b, d, H)
    assert b == rows * d * 4 + K * m_b * 4 + B * K * (3 * m_b + 2 * d) * 4 \
        + B * K * H * 8
    assert f == 4 * B * K * H * d


def test_kernels_count_on_meta_and_launch_nothing():
    meta = dict(device="meta")
    n0 = (fk.LAUNCHES, rk.LAUNCHES, sk.LAUNCHES,
          dict(fk.LAUNCHES_BY_SHAPE), dict(rk.LAUNCHES_BY_SHAPE))
    with counting.counting() as c:
        q = torch.empty(2, 16, 4, 64, dtype=torch.bfloat16, **meta)
        k = torch.empty(2, 16, 2, 64, dtype=torch.bfloat16, **meta)
        out = fa.flash_attention(q, k, k, window=8)
        a = torch.empty(2, 16, 8, requires_grad=True, **meta)
        h, h_last = rg.rglru_scan(a, a * 0.5)
        h.sum().backward()                       # + one reverse-time launch
        X = torch.empty(3, 16, 8, **meta)
        da, dw = sk.sdca_block_launch(
            X, torch.empty(3, 16, **meta), torch.empty(3, 16, **meta),
            torch.empty(8, **meta), torch.empty(3, 16, **meta),
            torch.empty(3, 5, dtype=torch.int32, **meta),
            loss=get_loss("squared"), lm=1.0)
    assert (out.shape, out.dtype, out.device.type) == \
        (q.shape, torch.bfloat16, "meta")
    assert h.shape == (2, 16, 8) and h_last.shape == (2, 8)
    assert da.shape == (3, 16) and dw.shape == (3, 8)
    # the wrappers' own counters count launches on the card only
    assert (fk.LAUNCHES, rk.LAUNCHES, sk.LAUNCHES,
            fk.LAUNCHES_BY_SHAPE, rk.LAUNCHES_BY_SHAPE) == n0
    ff, fb = fa.cost(2, 16, 16, 4, 2, 64, window=8)
    rf_, rb = rg.cost(2, 16, 8)
    sf, sb = sk.cost(3 * 5, 1, 3, 16, 8, 5)     # 5 draws of 16 rows a leaf
    assert c.flops == ff + 2 * rf_ + sf and c.bytes == fb + 2 * rb + sb
    assert c.by_shape() == {"flash_attention": {(2, 16, 16, 4, 2, 64): 1},
                            "rglru_scan": {(2, 16, 8): 2},
                            "sdca_block": {(1, 3, 16, 8, 5): 1}}


def test_counting_comm_prices_groups_by_node():
    # (data 2, model 4) = 8 positions: every group inside one node
    ctx = ShardContext(make_abstract_mesh((2, 4), ("data", "model")), None)
    assert {rf.link_of(c.ranks) for c in ctx.comms.values()} == {"nvlink"}
    # the production pod: a model group spans 16 positions, two nodes
    pod = ShardContext(make_abstract_mesh((16, 16), ("data", "model")),
                       None, rank=17)
    assert pod.coords == {"data": 1, "model": 1}
    assert pod.comms[("model",)].ranks == tuple(range(16, 32))
    assert rf.link_of(pod.comms[("model",)].ranks) == "network"
    assert rf.link_of(pod.comms[("data",)].ranks) == "network"
    x = torch.empty(4, 6, device="meta")
    assert pod.gather(x, 1, ("model",)).shape == (4, 96)
    assert pod.reduce_scatter(x.new_empty(32, 6), 0, ("data",)).shape == \
        (2, 6)
    assert pod.all_reduce(x, ("model",)).shape == (4, 6)
    assert [(c.op, c.result_bytes, c.group_size, c.axes)
            for c in pod.collectives] == [
        ("all-gather", 16 * 96, 16, ("model",)),
        ("reduce-scatter", 2 * 6 * 4, 16, ("data",)),
        ("all-reduce", 4 * 6 * 4, 16, ("model",))]
    ops, links = rf.aggregate(pod.collectives + pod.collectives[:1])
    assert [(o.op, o.count) for o in ops] == [
        ("all-gather", 2), ("reduce-scatter", 1), ("all-reduce", 1)]
    assert links == ["network"] * 3
    with pytest.raises(ValueError):
        pod.all_reduce(torch.zeros(2), ("model",))


def test_dryrun_cli_counts_a_full_size_cell(tmp_path):
    """recurrentgemma-2b x train_4k on the single-pod mesh, full width and
    depth, on the CPU with no process group: the reference's record keys,
    H100 terms."""
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "recurrentgemma-2b", "--shape", "train_4k",
                     "--mesh", "single", "--out", str(tmp_path)])
    assert done.value.code == 0
    rec = json.loads((tmp_path / "recurrentgemma-2b__train_4k__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert {"arch", "shape", "mesh", "kind", "status", "n_chips",
            "analysis_mode", "timings", "memory", "cost", "collectives",
            "roofline", "params_total", "params_active"} <= set(rec)
    assert set(rec["roofline"]) == set(ref_rf.roofline(
        {"flops": 1.0}, {"wire_bytes_per_chip": 0.0}, 1, 1.0))
    assert "fits_hbm_80gib" in rec["memory"]
    r = rec["roofline"]
    by_dtype = rec["cost"]["flops_by_dtype_per_chip"]
    assert sum(by_dtype.values()) == rec["cost"]["flops_per_chip"]
    # the scan computes in f32, priced outside the tensor cores
    assert by_dtype["float32"] >= rec["cost"]["kernel_flops"] > 0
    assert r["compute_s"] == pytest.approx(sum(
        f / (hw.PEAK_FLOPS_F32 if d == "float32" else hw.PEAK_FLOPS_BF16)
        for d, f in by_dtype.items()))
    assert r["memory_s"] == pytest.approx(
        rec["cost"]["bytes_per_chip"] / hw.HBM_BW)
    assert set(rec["collectives"]["by_link"]) == {"nvlink", "network"}
    # the train baseline: 4 microbatches, each 3 scan launches a recurrent
    # layer of a block (forward, remat recompute, reverse time) and 2 a
    # tail layer (no remat), at rank 0's shape
    cfg = registry.get_config("recurrentgemma-2b")
    kinds = cfg.layer_kinds()
    tail = len(kinds) % len(cfg.block_pattern)
    in_blocks = sum(k == "rec" for k in kinds[:len(kinds) - tail])
    in_tail = sum(k == "rec" for k in kinds[len(kinds) - tail:])
    (_, n), = rec["cost"]["kernel_launches"]["rglru_scan"].items()
    assert n == 4 * (3 * in_blocks + 2 * in_tail)
    assert r["model_flops"] == ref_rf.model_flops(
        ref_registry.get_config("recurrentgemma-2b"),
        ref_shapes.SHAPES["train_4k"])
