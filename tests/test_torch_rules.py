"""The port's AST lint (repro_torch/analysis/rules.py, ``python -m
repro_torch.analysis``) on the CPU.

Every lint fixture of the JAX package's tests (tests/test_analysis.py),
rewritten in torch idiom, gives the reference fixture's rule list,
waivers included, with two renames: the reference's
``jit-outside-engine`` is ``compile-outside-engine`` here, and its
``undonated-carry`` has no counterpart (eager PyTorch donates no buffer),
so those three fixtures give no finding.  New cases cover
``host-sync-in-tick``, ``compile-outside-engine``, autograd Functions and
import aliases; the shipped port is clean, and ``--strict`` exits 0.
"""
import glob
import textwrap

import pytest

from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import rules as lint


def _lint(tmp_path, source, name="pkg/fixture.py"):
    f = tmp_path / name
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(source))
    return lint.lint_file(str(f))


def _rules(findings):
    return [f.rule for f in findings]


# ---------------------------------------------------------------------------
# the reference's fixtures, in torch idiom
# ---------------------------------------------------------------------------
def test_lint_static_lambda_closure(tmp_path):
    findings = _lint(tmp_path, """\
        import torch

        def make_step(lam):
            @torch.compile
            def step(alpha):
                return alpha * lam
            return step
        """)
    assert _rules(findings) == ["static-operand-capture"]
    assert "lam" in findings[0].message


def test_lint_operand_as_argument_is_clean(tmp_path):
    assert _lint(tmp_path, """\
        import torch

        @torch.compile
        def step(alpha, lam):
            return alpha * lam
        """) == []


def test_lint_wallclock_and_random_in_trace(tmp_path):
    findings = _lint(tmp_path, """\
        import time, random
        import torch

        @torch.compile
        def f(x):
            t0 = time.time()
            return x + random.random() + t0
        """)
    assert {"wall-clock-in-trace", "python-random-in-trace"} == \
        set(_rules(findings))


def test_lint_wallclock_outside_trace_is_clean(tmp_path):
    assert _lint(tmp_path, """\
        import time

        def bench(f):
            t0 = time.time()
            f()
            return time.time() - t0
        """) == []


def test_lint_compile_location(tmp_path):
    src = """\
        import torch

        @torch.compile
        def f(x):
            return x + 1
        """
    bad = _lint(tmp_path, src, name="src/repro_torch/launch/stray.py")
    assert _rules(bad) == ["compile-outside-engine"]
    assert _lint(tmp_path, src,
                 name="src/repro_torch/core/engine/fine.py") == []
    assert _lint(tmp_path, src, name="tests/fine.py") == []


def test_lint_traced_via_vmap(tmp_path):
    findings = _lint(tmp_path, """\
        import time
        import torch

        def outer(xs):
            def body(x):
                return x + time.time()
            return torch.func.vmap(body)(xs)
        """)
    assert _rules(findings) == ["wall-clock-in-trace"]


def test_lint_frozen_mutable_default(tmp_path):
    findings = _lint(tmp_path, """\
        import dataclasses

        @dataclasses.dataclass(frozen=True)
        class Cfg:
            xs: list = []
            ys: dict = dict()
        """)
    assert _rules(findings) == ["mutable-default-in-frozen-dataclass"] * 2


def test_lint_waiver_comment(tmp_path):
    assert _lint(tmp_path, """\
        import torch

        @torch.compile  # analysis: allow(compile-outside-engine) fixture
        def f(x):
            return x + 1
        """, name="src/repro_torch/launch/waived.py") == []


def test_lint_carry_step_has_no_donation_rule(tmp_path):
    """The reference's undonated-carry fixtures: eager PyTorch has no
    buffer donation, so a compiled carry step in the engine is clean."""
    assert _lint(tmp_path, """\
        import torch

        def _build():
            def step_chunk(X, y, state):
                return state
            return torch.compile(step_chunk)
        """, name="src/repro_torch/core/engine/fine.py") == []
    assert _lint(tmp_path, """\
        import torch

        def _build():
            def program_state_b(state, ops):
                return state
            return torch.compile(torch.func.vmap(program_state_b))
        """, name="src/repro_torch/core/engine/mesh_fixture.py") == []
    assert _lint(tmp_path, """\
        import torch

        def _build():
            def step(state):
                return state
            return torch.compile(step)
        """, name="pkg/runner.py") == []


def test_lint_operand_threaded_through_helper_is_clean(tmp_path):
    """A runtime operand that reaches an inner step body through a
    helper's parameter is an operand at every call site, not a baked
    constant: the call graph makes the helper a step body too."""
    assert _lint(tmp_path, """\
        import torch

        def _scan(xs, lam):
            def body(x):
                return x * lam
            return torch.func.vmap(body)(xs)

        @torch.compile
        def solve(xs, lam):
            return _scan(xs, lam)
        """, name="src/repro_torch/core/engine/helper_fixture.py") == []


# ---------------------------------------------------------------------------
# the port's own cases
# ---------------------------------------------------------------------------
TICK = """\
    import time
    import torch

    class HostExecutor:
        def step(self, data, keys, state, participation, steps, lm):
            return self._run(data, keys, state, [float(lm)])

        def _run(self, data, keys, state, lm_host):
            for s in range(4):
                n = int(state.sum().item())
                state = self._sync(s, state)
            return state

        def _sync(self, s, state):
            torch.cuda.synchronize()
            return helper(state)

        def finalize(self, state):
            return state.cpu()          # outside the tick loop: fine

    def helper(state):
        return state.tolist()
    """


def test_host_sync_in_tick_follows_the_tick_bodies(tmp_path):
    findings = _lint(tmp_path, TICK,
                     name="src/repro_torch/core/engine/host.py")
    assert sorted((f.rule, f.line) for f in findings) == [
        ("host-sync-in-tick", 10), ("host-sync-in-tick", 15),
        ("host-sync-in-tick", 22)]
    # the same class in another file is no tick body
    assert _lint(tmp_path, TICK, name="src/repro_torch/api/other.py") == []


def test_host_sync_in_tick_waiver(tmp_path):
    src = TICK.replace(
        "n = int(state.sum().item())",
        "n = int(state.sum().item())  # analysis: allow(host-sync-in-tick) x"
    ).replace("torch.cuda.synchronize()",
              "torch.cuda.synchronize()  # analysis: allow(host-sync-in-tick)"
              ).replace(
        "def helper(state):",
        "def helper(state):  # analysis: allow(host-sync-in-tick) owner")
    assert _lint(tmp_path, src,
                 name="src/repro_torch/core/engine/host.py") == []


def test_compile_outside_engine_covers_jit_and_graphs(tmp_path):
    findings = _lint(tmp_path, """\
        import torch
        from torch import jit

        def build(f, x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = f(x)
            return jit.script(f), torch.jit.trace(f, x), \\
                torch.cuda.make_graphed_callables(f, (x,)), g, y
        """, name="src/repro_torch/api/stray.py")
    assert _rules(findings) == ["compile-outside-engine"] * 5
    assert _lint(tmp_path, """\
        import torch

        def build(f):
            return torch.compile(f)
        """, name="src/repro_torch/kernels/fine.py") == []


def test_autograd_function_bodies_and_imported_transforms(tmp_path):
    findings = _lint(tmp_path, """\
        import random
        import time
        import torch
        from torch.utils.checkpoint import checkpoint

        class Scan(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x * random.random()

            @staticmethod
            def backward(ctx, g):
                return g

        def forward_all(blk, x, lr):
            def inner(blk, x):
                return x * lr + time.perf_counter()
            return checkpoint(inner, blk, x, use_reentrant=False)
        """)
    assert sorted(_rules(findings)) == [
        "python-random-in-trace", "static-operand-capture",
        "wall-clock-in-trace"]


def test_graph_capture_block_is_a_step_body(tmp_path):
    findings = _lint(tmp_path, """\
        import time
        import torch

        def run(f, x, g):
            with torch.cuda.graph(g):
                y = f(x) + time.time()
            return y
        """, name="src/repro_torch/core/engine/graphs.py")
    assert _rules(findings) == ["wall-clock-in-trace"]


# ---------------------------------------------------------------------------
# the shipped tree
# ---------------------------------------------------------------------------
def _port_files():
    return ["src/repro_torch"] + sorted(glob.glob("tests/test_torch_*.py"))


def test_lint_shipped_port_is_clean():
    assert lint.lint_paths(_port_files()) == []


def test_cli_strict_exits_zero(capsys):
    assert cli.main(["--strict"] + _port_files()) == 0
    assert "clean" in capsys.readouterr().out


def test_cli_reports_findings(tmp_path, capsys):
    f = tmp_path / "bad.py"
    f.write_text("import torch, time\n\n@torch.compile\ndef f(x):\n"
                 "    return x + time.time()\n")
    assert cli.main([str(f)]) == 1
    assert "[wall-clock-in-trace]" in capsys.readouterr().err


@pytest.mark.parametrize("name", sorted(lint.TICK_BODIES))
def test_tick_bodies_name_methods_that_exist(name):
    """Every listed tick body is a method of the named class in the
    shipped file (a rename would silently drop it from the rule)."""
    import ast
    tree = ast.parse(open(f"src/repro_torch/{name}").read())
    have = {f"{c.name}.{d.name}" for c in ast.walk(tree)
            if isinstance(c, ast.ClassDef) for d in c.body
            if isinstance(d, ast.FunctionDef)}
    assert lint.TICK_BODIES[name] <= have
