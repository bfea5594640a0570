"""SVM (smoothed hinge) on the PyTorch/CUDA port over three topologies
(``examples/svm_tree_network.py``'s program), showing the paper's
headline effect: when the root links are slow, deeper trees that localize
communication converge faster in wall-clock terms.

    PYTHONPATH=src python examples/torch_svm_tree_network.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.api import Problem, Schedule, Session, Topology
from repro_torch.core.prng import PRNGKey
from repro_torch.data.synthetic import gaussian_classification

LAM = 0.02
T_LP = 1e-5
SLOW = 1e5 * T_LP   # root-link delay (paper Fig. 3 regime)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    X, y = gaussian_classification(m=1024, d=64, device=args.device)
    problem = Problem.svm(X, y, lam=LAM, smoothing=1.0)
    key = PRNGKey(1)

    topologies = {
        "star-8 (CoCoA)": (
            Topology.star(8, 128, t_lp=T_LP, t_delay=SLOW),
            Schedule(rounds=12, local_steps=384)),
        "tree 2x4": (
            Topology.two_level(2, 4, 128, t_lp=T_LP, root_delay=SLOW,
                               group_delay=1e-4),
            Schedule(rounds=6, level_rounds=[2], local_steps=384)),
        "tree 4x2": (
            Topology.two_level(4, 2, 128, t_lp=T_LP, root_delay=SLOW,
                               group_delay=1e-4),
            Schedule(rounds=6, level_rounds=[2], local_steps=384)),
    }

    print(f"{'topology':<16}{'sim-time(s)':>12}{'final gap':>14}"
          f"{'gap @ t=13s':>14}")
    for name, (topo, sched) in topologies.items():
        res = Session.compile(problem, topo, sched, backend="cuda",
                              device=args.device).run(key=key)
        # gap at a common wall-clock budget
        t_common = 13.0
        i = max(int(np.searchsorted(res.times, t_common, "right")) - 1, 0)
        print(f"{name:<16}{res.times[-1]:>12.2f}{res.gaps[-1]:>14.3e}"
              f"{res.gaps[i]:>14.3e}")

    print("\n(deeper trees pay the slow root hop fewer times per unit of "
          "local progress)")


if __name__ == "__main__":
    main()
