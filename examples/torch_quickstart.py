"""Quickstart on the PyTorch/CUDA port (``examples/quickstart.py``'s
program): ridge regression by distributed dual coordinate ascent on a
2-level tree network (root -> 2 sub-centers -> 4 workers), the duality
gap streamed per round, a warm restart for a few extra rounds, and the
closed-form optimum as the certificate.  The leaf solves run the
``sdca_block`` kernel on the card (its plain version on the CPU).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.api import Problem, Schedule, Session, Topology
from repro_torch.core.dual import dual_value, ridge_dual_optimum
from repro_torch.core.prng import PRNGKey
from repro_torch.data.synthetic import gaussian_regression


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    X, y = gaussian_regression(m=512, d=64, device=args.device)
    problem = Problem(X, y, loss="squared", lam=0.05)

    # the network: 2 sub-centers, 2 leaf workers each, 128 points/worker
    topology = Topology.two_level(
        n_groups=2, workers_per_group=2, m_per_worker=128,
        root_delay=0.5e-1, group_delay=1e-4, t_lp=1e-5)
    schedule = Schedule(rounds=10, level_rounds=[2], local_steps=256)

    session = Session.compile(problem, topology, schedule, backend="cuda",
                              device=args.device)

    print("round  sim-time(s)   duality-gap")
    res = session.run(key=PRNGKey(0), on_round=lambda h: print(
        f"{h['round']:>5}  {h['time']:>11.4f}   {h['gap']:.3e}"))

    # warm restart: 5 more rounds, continuing the state and RNG chain
    res = session.run(rounds=5, warm_start=res)
    print(f"after warm restart (+5 rounds): gap {res.history[-1]['gap']:.3e}")

    # certificate: compare with the exact dual optimum
    a_star = ridge_dual_optimum(X, y, problem.lam)
    d_star = float(dual_value(a_star, X, y, problem.loss, problem.lam))
    d_ours = float(dual_value(res.alpha, X, y, problem.loss, problem.lam))
    print(f"\nD(alpha*) = {d_star:.6f}")
    print(f"D(ours)   = {d_ours:.6f}  (suboptimality {d_star - d_ours:.2e})")
    w_err = float(torch.linalg.norm(
        res.w - (X.T @ a_star) / (problem.lam * X.shape[0])))
    print(f"||w - w*|| = {w_err:.2e}")
    assert d_star - d_ours < 1e-3, "did not reach the optimum"

    # the topology is a serializable spec
    rt = Topology.from_json(topology.to_json())
    assert rt == topology
    print("topology JSON round-trip: ok")


if __name__ == "__main__":
    main()
