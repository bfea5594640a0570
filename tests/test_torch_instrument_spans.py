"""The port's spans and counters (``core/instrument.py``: ``span``,
``count``, ``snapshot``, ``reset``) on the solve path: off unless a
``torch.profiler`` session records, exact counts under one, the same
iterates either way, and flat phases inside a run.  Debug-size trees on
the CPU; the device events of ``tick.draw`` on the card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.api import Problem, Schedule, Session, Sweep  # noqa: E402
from repro_torch.api import Topology  # noqa: E402
from repro_torch.core import instrument  # noqa: E402
from repro_torch.core.prng import PRNGKey  # noqa: E402

ROUNDS = 3
FANOUTS = [2, 2, 2]
M_LEAF = 16
H = 16


@pytest.fixture(autouse=True)
def fresh_aggregates():
    instrument.reset()
    yield
    instrument.reset()


def _session(device="cpu", backend="torch"):
    topo = Topology.balanced(FANOUTS, m_leaf=M_LEAF)
    g = torch.Generator().manual_seed(5)
    X = torch.randn(topo.m_total, 8, generator=g)
    y = torch.sign(torch.randn(topo.m_total, generator=g))
    sched = Schedule(rounds=ROUNDS, level_rounds=[2, 2], local_steps=H)
    return Session.compile(Problem(X, y, loss="hinge", lam=0.01), topo,
                           sched, backend=backend, device=device)


def _run(sess):
    seen = []
    res = sess.run(key=PRNGKey(3), on_round=seen.append)
    assert len(seen) == ROUNDS + 1
    return res


def _sweep(sess):
    return sess.sweep(Sweep(lams=[0.01, 0.003], seeds=[PRNGKey(1)]))


def _operand_bytes(plan, B=1):
    """Key plan (int64 pairs), step mask and participation mask bytes."""
    S, n = plan.n_ticks, plan.n_leaves
    return B * (ROUNDS * S * n * 2 * 8 + S * n * plan.h_max * 4) + S * n * 4


def _expected_ticks(plan):
    """(solve ticks, ticks with a sync) of a root round."""
    return (int((plan.solve_mask.max(axis=1) > 0).sum()),
            int((plan.sync_mask.max(axis=2) > 0).any(axis=1).sum()))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    entered = []

    class Spy:
        def __init__(self, *a, **k):
            entered.append(a)

    monkeypatch.setattr(torch.profiler, "record_function", Spy)
    assert not instrument.tracing()
    sess = _session()
    _run(sess)
    _sweep(sess)
    with instrument.span("tick.draw", device="cpu", tick=0) as s:
        assert s is None
    instrument.count("host_syncs")
    instrument.count_h2d(np.zeros(4), torch.zeros(4))
    assert entered == []
    assert instrument.snapshot() == {"spans": {}, "device_ms": {},
                                     "counts": {}}


def test_profiled_run_counts_every_phase():
    sess = _session()
    plan = sess.plan
    _profiled(lambda: _run(sess))
    snap = instrument.snapshot()
    spans, counts = snap["spans"], snap["counts"]
    solves, syncs = _expected_ticks(plan)
    assert spans["key_plan"]["count"] == 1
    assert spans["step_mask"]["count"] == 1
    assert spans["record"]["count"] == ROUNDS + 1
    for phase in ("tick.draw", "tick.solve"):
        assert spans[phase]["count"] == ROUNDS * solves
    assert spans["tick.sync"]["count"] == ROUNDS * syncs
    assert counts == {"h2d_bytes": _operand_bytes(plan),
                      "host_syncs": ROUNDS + 1}
    assert snap["device_ms"] == {}            # no CUDA stream on the CPU
    assert all(v["seconds"] > 0 for v in spans.values())


def test_profiled_sweep_counts_one_group():
    sess = _session()
    plan = sess.plan
    _profiled(lambda: _sweep(sess))
    snap = instrument.snapshot()
    spans, counts = snap["spans"], snap["counts"]
    solves, syncs = _expected_ticks(plan)
    assert spans["key_plan"]["count"] == 1
    assert spans["step_mask"]["count"] == 1
    for phase in ("tick.draw", "tick.solve"):
        assert spans[phase]["count"] == ROUNDS * solves
    assert spans["tick.sync"]["count"] == ROUNDS * syncs
    assert counts == {"h2d_bytes": _operand_bytes(plan, B=2),
                      "host_syncs": 1}


def test_iterates_equal_with_tracing_on_and_off():
    sess = _session()
    off_run, off_sweep = _run(sess), _sweep(sess)
    (on_run, on_sweep), _ = _profiled(lambda: (_run(sess), _sweep(sess)))
    assert torch.equal(off_run.alpha, on_run.alpha)
    assert torch.equal(off_run.w, on_run.w)
    assert off_run.gaps.tolist() == on_run.gaps.tolist()
    assert torch.equal(off_sweep.alphas, on_sweep.alphas)
    assert torch.equal(off_sweep.ws, on_sweep.ws)


@pytest.mark.parametrize("what", ["run", "sweep"])
def test_phases_are_flat_inside_a_run(what):
    sess = _session()
    _, prof = _profiled(lambda: _run(sess) if what == "run"
                        else _sweep(sess))
    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.name.startswith(instrument.SPAN_PREFIX))
    names = {n for _, _, n in ranges}
    assert {"repro_torch.key_plan", "repro_torch.tick.draw",
            "repro_torch.tick.solve", "repro_torch.tick.sync",
            "repro_torch.record"} <= names
    for (_, end, a), (start, _, b) in zip(ranges, ranges[1:]):
        assert end <= start, f"{b} starts inside {a}"


def test_h2d_counts_host_data_only():
    dev = torch.zeros(3)
    with profile(activities=[ProfilerActivity.CPU]):
        instrument.count_h2d(np.zeros(5, np.float32),
                             torch.zeros(5))          # from host: 20 B
        instrument.count_h2d([1.0, 2.0], torch.zeros(2))   # 8 B
        instrument.count_h2d(dev, dev.double())       # same device: no copy
    assert instrument.snapshot()["counts"] == {"h2d_bytes": 28}


def test_reset_and_run_ids():
    with profile(activities=[ProfilerActivity.CPU]):
        instrument.begin_run()
        first = dict(instrument._attrs)
        instrument.at_round(2)
        instrument.begin_run()
        second = dict(instrument._attrs)
        instrument.count("host_syncs", 3)
    assert second["run"] == first["run"] + 1 and "round" not in second
    assert instrument.snapshot()["counts"] == {"host_syncs": 3}
    instrument.reset()
    assert instrument.snapshot()["counts"] == {}


@pytest.mark.parametrize("idle_at_open", [(True, False), (False, False),
                                          (True, True), (False, True, False)])
def test_draw_events_time_only_spans_opened_on_a_busy_stream(idle_at_open,
                                                            monkeypatch):
    """A span on a CUDA device records its event pair only where the
    stream still has work queued when it opens (an idle stream would run
    each launch as the host issues it); the host aggregate counts all."""
    idle = list(idle_at_open)
    made = []

    class Stream:
        def query(self):
            return idle.pop(0)

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            made.append(self)

        def record(self, stream):
            self.stream = stream

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return 2.5

    stream = Stream()
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: stream)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    with profile(activities=[ProfilerActivity.CPU]):
        for s in range(len(idle_at_open)):
            with instrument.span("tick.draw", device="cuda", tick=s):
                pass
    snap = instrument.snapshot()
    busy = idle_at_open.count(False)
    assert idle == [] and len(made) == 2 * busy
    assert all(e.stream is stream for e in made)
    assert snap["spans"]["tick.draw"]["count"] == len(idle_at_open)
    assert snap["device_ms"] == ({"tick.draw": {"count": busy,
                                                "ms": 2.5 * busy}}
                                 if busy else {})


@pytest.mark.cuda
def test_draw_events_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: tick.draw's CUDA events")
    x = torch.ones(1 << 20, device="cuda")
    with profile(activities=[ProfilerActivity.CPU]):
        torch.cuda._sleep(1 << 28)                # ~0.14 s of device time
        with instrument.span("tick.draw", device="cuda", tick=0):
            x * 2                                 # queued behind the sleep
        torch.cuda.synchronize()
        with instrument.span("tick.draw", device="cuda", tick=1):
            x * 2                                 # opens on an idle stream
    snap = instrument.snapshot()
    assert snap["spans"]["tick.draw"]["count"] == 2
    draw = snap["device_ms"]["tick.draw"]
    # one pair, around the product alone and not the sleep before it
    assert draw["count"] == 1 and 0 < draw["ms"] < 50
    instrument.reset()
    # a profiled run on the card: every tick's span, a pair where a tick
    # opened on a busy stream, the operands' exact bytes
    sess = _session(device="cuda", backend="cuda")
    _run(sess)                                    # builds the kernels
    instrument.reset()
    _profiled(lambda: _run(sess))
    snap = instrument.snapshot()
    solves, _ = _expected_ticks(sess.plan)
    assert snap["spans"]["tick.draw"]["count"] == ROUNDS * solves
    pairs = snap["device_ms"].get("tick.draw", {"count": 0})["count"]
    assert pairs <= ROUNDS * solves
    assert snap["counts"]["h2d_bytes"] == _operand_bytes(sess.plan)
    # every tick's draws were one threefry_randint launch
    assert snap["counts"]["draw.kernel_ticks"] == ROUNDS * solves
