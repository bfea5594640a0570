"""The port's dry-run (launch/dryrun.py, launch/steps.py::CellProgram.lower,
launch/lowered.py, the counting comm of models/shardctx.py) and perf
tool (launch/perf.py) on the CPU, no process group:

  * every (arch x shape) cell that ``cell_is_supported`` accepts counts
    with ``status="ok"`` at SMOKE width on an abstract (data 2, model 2)
    mesh, the shapes cut to CUT_SEQ tokens x CUT_BATCH rows (their names
    and kinds kept); the others are skipped with the reference's reason;
  * the counted matmul flops of a dense train cell (h2o-danube SMOKE, one
    rank) equal an analytic count of its products: the layer products
    four times (forward, remat recompute, two backward products) but for
    each block's last one (the MLP's down projection: a non-reentrant
    checkpoint stops its recompute once every tensor the backward saved
    exists), and the chunked logits four times (forward, checkpoint
    recompute, backward);
  * on 4 gloo ranks spawned once for the module as (data, model) =
    (2, 2), the collectives rank 0 of a real run makes -- its ``GroupComm``
    calls recorded -- equal, call by call (op, result bytes, group size,
    axes), those the counting comm records for rank 0 of the same cell
    counted on meta, for a dense (qwen3-32b), an MoE (dbrx-132b) and an
    RWKV6 SMOKE cell, in train, prefill and decode;
  * ``perf.run_variant`` runs one variant.

The rank program is this module's ``_rank_main``; the spawned processes
import this file, so nothing at its top level imports JAX.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import ARCHS, get_smoke_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch import dryrun, perf, steps  # noqa: E402
from repro_torch.launch import roofline as rf  # noqa: E402
from repro_torch.launch.mesh import RankMesh, make_abstract_mesh  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.runtime import ranks  # noqa: E402

WORLD = 4
SPAWN_TIMEOUT = 240.0
CUT_SEQ, CUT_BATCH = 32, 8
GLOO_CASES = ("qwen3-32b", "dbrx-132b", "rwkv6-1.6b")
KINDS = ("train", "prefill", "decode")


def _cut(name: str) -> ShapeSpec:
    s = SHAPES[name]
    return ShapeSpec(s.name, CUT_SEQ, CUT_BATCH, s.kind)


def _mesh22():
    return make_abstract_mesh((2, 2), ("data", "model"))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_every_supported_cell_counts_at_smoke_width(arch):
    cfg = get_smoke_config(arch)
    for name in SHAPES:
        rec = dryrun.run_cell(arch, name, "abstract22", cfg=cfg,
                              shape=_cut(name), mesh=_mesh22(),
                              verbose=False)
        ok, why = steps.cell_is_supported(cfg, SHAPES[name])
        if not ok:
            assert rec["status"] == "skipped" and rec["reason"] == why
            continue
        assert rec["status"] == "ok", rec.get("error")
        assert rec["n_chips"] == 4
        assert rec["cost"]["flops_per_chip"] > 0
        assert rec["cost"]["bytes_per_chip"] > 0
        mem = rec["memory"]
        assert mem["peak_bytes_per_device"] >= mem["argument_bytes"] > 0
        assert rec["roofline"]["step_time_lower_bound_s"] > 0
        # every cell of a (2, 2) mesh runs collectives over both axes
        assert rec["collectives"]["n_ops"] > 0
        json.dumps(rec)                   # the record is JSON


def _products(cfg, B, S):
    """Forward matmul flops of a dense GQA model's layers, of each layer's
    down projection, and of the logits."""
    T, D, hd = B * S, cfg.d_model, cfg.head_dim
    H, KV, F, V = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size
    proj = 2 * T * D * (2 * H * hd + 2 * KV * hd)     # q, k, v, o
    scores = 2 * (2 * B * H * S * S * hd)            # QK^T and PV (S x S)
    mlp = 3 * 2 * T * D * F                          # SwiGLU
    return (cfg.num_layers * (proj + scores + mlp),
            cfg.num_layers * 2 * T * F * D, 2 * T * D * V)


def test_counted_matmul_flops_of_a_dense_train_cell_are_analytic():
    cfg = get_smoke_config("h2o-danube-1.8b")
    B, S = 4, cfg.q_chunk_size
    cell = steps.build_cell(cfg, ShapeSpec("train_4k", S, B, "train"),
                            make_abstract_mesh((1, 1), ("data", "model")))
    lowered = cell.lower()
    layers, down, logits = _products(cfg, B, S)
    assert cfg.remat
    assert lowered.kernel_flops == 0
    assert lowered.flops == 4 * layers - down + 4 * logits
    no_remat = steps.build_cell(
        dataclasses.replace(cfg, remat=False),
        ShapeSpec("train_4k", S, B, "train"),
        make_abstract_mesh((1, 1), ("data", "model"))).lower()
    assert no_remat.flops == 3 * layers + 4 * logits
    assert lowered.calls == []


def test_lower_counts_the_kernels_and_their_launches():
    """recurrentgemma SMOKE prefill on flash: every attention layer one
    flash launch and every recurrent layer one scan launch, at the local
    shapes, their costs included."""
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"),
                              attention_impl="flash")
    kinds = cfg.layer_kinds()
    B, S = 2, 32
    lowered = steps.build_cell(
        cfg, ShapeSpec("prefill_32k", S, B, "prefill"),
        make_abstract_mesh((1, 2), ("data", "model"))).lower()
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rglru import ops as rg
    assert lowered.launches["rglru_scan"] == {
        (B, S, cfg.lru_width // 2): sum(k == "rec" for k in kinds)}
    (key, n), = lowered.launches["flash_attention"].items()
    assert n == sum(k == "attn" for k in kinds)
    assert key[:4] == (B, S, S, cfg.num_heads // 2)   # the local heads
    f_flops, f_bytes = fa.cost(*key, window=cfg.window)
    s_flops, s_bytes = rg.cost(B, S, cfg.lru_width // 2)
    n_rec = sum(k == "rec" for k in kinds)
    assert lowered.kernel_flops == n * f_flops + n_rec * s_flops
    assert lowered.kernel_bytes == n * f_bytes + n_rec * s_bytes
    # the kernels' counting route launched nothing
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rglru import kernel as rk
    assert fk.LAUNCHES == 0 and rk.LAUNCHES == 0


def test_perf_run_variant_runs_one_variant(tmp_path, monkeypatch):
    monkeypatch.setattr(perf, "RESULTS", tmp_path)
    rec = perf.run_variant("qwen3-32b", "train_4k", "abstract22", "mb2",
                           cfg=get_smoke_config("qwen3-32b"),
                           shape=_cut("train_4k"), mesh=_mesh22())
    assert rec["status"] == "ok" and rec["variant"] == "mb2"
    assert (tmp_path / "qwen3-32b__train_4k__abstract22__mb2.json").exists()


def test_dryrun_cli_lists_the_cells(capsys):
    dryrun.main(["--list", "--arch", "qwen3-32b"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "qwen3-32b train_4k OK"
    assert out[-1].startswith("qwen3-32b long_500k SKIP")


# ---------------------------------------------------------------------------
# the counting comm against a real gloo run, call by call
# ---------------------------------------------------------------------------
class _Recorder:
    """A ``GroupComm`` whose collective calls are logged as the counting
    comm logs them."""

    def __init__(self, comm, axes, log):
        self._comm, self._axes, self._log = comm, axes, log

    def __getattr__(self, name):
        return getattr(self._comm, name)

    def _note(self, op, out):
        self._log.append((op, out.numel() * out.element_size(),
                          self._comm.size, self._axes))
        return out

    def all_reduce(self, x):
        return self._note("all-reduce", self._comm.all_reduce(x))

    def gather_rows(self, x):
        return self._note("all-gather", self._comm.gather_rows(x))

    def reduce_scatter(self, x):
        return self._note("reduce-scatter", self._comm.reduce_scatter(x))


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32))
            for k in ("tokens", "labels")}


def _cells(cfg, mesh):
    return {k: steps.build_cell(cfg, dataclasses.replace(
        SHAPES[{"train": "train_4k", "prefill": "prefill_32k",
                "decode": "decode_32k"}[k]], seq_len=CUT_SEQ,
        global_batch=CUT_BATCH), mesh) for k in KINDS}


def _rank_main(rank, world, pg, root):
    ranks.init(rank, world, f"file://{pg}")
    torch.manual_seed(0)
    mesh = RankMesh([[0, 1], [2, 3]], device_type="cpu")
    got = {}
    for arch in GLOO_CASES:
        cfg = get_smoke_config(arch)
        cells = _cells(cfg, mesh)
        ctx = cells["train"].ctx
        log = []
        for axes, comm in list(ctx.comms.items()):
            inner = comm._comm if isinstance(comm, _Recorder) else comm
            ctx.comms[axes] = _Recorder(inner, axes, log)
        params = transformer.stack_blocks(
            transformer.init_params(cfg, prng.PRNGKey(0), device="cpu"))
        batch = _batch(cfg, CUT_BATCH, CUT_SEQ)
        tr = cells["train"]
        opt = get_optimizer(cfg).init(params)
        del log[:]
        tr(tr.local(0, params), tr.local(1, opt), tr.local(2, batch))
        got[(arch, "train")] = list(log)
        pre, dec = cells["prefill"], cells["decode"]
        local_p = pre.local(0, params)
        del log[:]
        with torch.no_grad():
            _, cache = pre(local_p, pre.local(1, {"tokens":
                                                  batch["tokens"]}))
        got[(arch, "prefill")] = list(log)
        del log[:]
        with torch.no_grad():
            dec(local_p, cache, dec.local(2, batch["tokens"][:, :1]))
        got[(arch, "decode")] = list(log)
    if rank == 0:
        torch.save(got, f"{root}/rank0.pt")


@pytest.fixture(scope="module")
def gloo_calls(tmp_path_factory):
    root = tmp_path_factory.mktemp("dryrun")
    ranks.spawn(_rank_main, WORLD, args=(WORLD, str(root / "pg"), str(root)),
                timeout=SPAWN_TIMEOUT)
    return torch.load(root / "rank0.pt", weights_only=False)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", GLOO_CASES)
def test_counting_comm_equals_a_real_runs_calls(gloo_calls, arch, kind):
    want = gloo_calls[(arch, kind)]
    cell = _cells(get_smoke_config(arch), _mesh22())[kind]
    lowered = cell.lower(rank=0)
    got = [(c.op, c.result_bytes, c.group_size, c.axes)
           for c in lowered.calls]
    assert want, "the real run made no collective"
    assert got == want
    # a (2, 2) mesh of one node: every group is on NVLink
    assert set(rf.aggregate(lowered.calls)[1]) == {"nvlink"}
