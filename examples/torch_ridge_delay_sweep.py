"""Delay-aware tuning on the PyTorch/CUDA port
(``examples/ridge_delay_sweep.py``'s program, paper §6): for a range of
link delays, ``Schedule.auto`` picks the eq.-(12)-optimal local iteration
count H from the topology's delay model, checked against simulated CoCoA
runs (star sessions, one batched sweep over the schedules) on ridge
regression.

    PYTHONPATH=src python examples/torch_ridge_delay_sweep.py [--device cpu]
"""
import argparse

from repro_torch.api import Problem, Schedule, Session, Topology
from repro_torch.core.delay import optimal_h
from repro_torch.core.dual import duality_gap
from repro_torch.data.synthetic import gaussian_regression

T_LP, T_CP, LAM, K = 4e-5, 3e-5, 1e-2, 3
BUDGET = 2.0  # seconds of simulated wall-clock


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--delays", type=float, nargs="+",
                    default=[1.0, 100.0, 1e4],
                    help="link delays r, in units of t_lp")
    args = ap.parse_args(argv)
    X, y = gaussian_regression(m=600, d=100, device=args.device)
    m = X.shape[0]
    problem = Problem.ridge(X, y, lam=LAM)

    print(f"{'r':>10} {'H* (auto)':>12} {'best H (sim)':>14} "
          f"{'gap @ H*':>12}")
    for r in args.delays:
        t_delay = r * T_LP
        topo = Topology.star(K, m // K, t_lp=T_LP, t_cp=T_CP,
                             t_delay=t_delay)

        # the session's auto schedule runs eq. (12) at compile time
        auto = Session.compile(
            problem, topo,
            Schedule.auto(t_total=BUDGET, C=0.5, delta=1 / (m // K),
                          t_cp=T_CP, h_max=10**6),
            backend="cuda", device=args.device)
        h_star = auto.resolved.chunk_tree.leaves()[0].rounds
        h_ref, _ = optimal_h(C=0.5, K=K, delta=1 / (m // K), t_total=BUDGET,
                             t_lp=T_LP, t_delay=t_delay, t_cp=T_CP,
                             h_max=10**6)
        assert h_star == h_ref, (h_star, h_ref)

        # simulate a small grid around H* -- one batched sweep over the
        # schedule axis -- and report the empirical best
        hs = sorted({max(h_star // 8, 1), max(h_star // 2, 1), h_star,
                     h_star * 2, h_star * 8})
        scheds = [
            Schedule(rounds=min(max(int(
                BUDGET / (T_LP * H + t_delay + T_CP)), 1), 2000),
                local_steps=H)
            for H in hs
        ]
        rs = auto.sweep(schedules=scheds, record_history=False)
        gaps = {
            H: float(duality_gap(res.alpha, X, y, problem.loss, LAM))
            for H, res in zip(hs, rs, strict=True)
        }
        best = min(gaps, key=gaps.get)
        print(f"{r:>10.0f} {h_star:>12d} {best:>14d} {gaps[h_star]:>12.3e}")
        # the eq.-(12) pick is within ~8x of the empirical best
        assert best / 8 <= h_star <= best * 8, (r, h_star, best)

    print("\n(the analytic H* tracks the empirically-best H across delay "
          "regimes)")


if __name__ == "__main__":
    main()
