"""GLM fitting launcher — the paper's end-to-end driver, reduced; port of
``repro/launch/fit.py`` for ``--executor local``.

``python -m repro_torch.launch.fit --problem logistic --nodes 1
     --rows-per-node 4194304 --features 307``

The data come from ``classification_problem`` as in the JAX CLI; the solve
is ``UnwrappedADMM.solve`` with the ``_admm_params`` table (logistic
tau=0.1; SVM C=1, rho=1, tau=0.5), the same solver semantics as the JAX
shard_map branch. It runs on the card (``--device cuda``) unless asked for
the CPU. The JAX CLI's other flags exit with the ROADMAP item that ports
them.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.prox import make_hinge, make_logistic
from repro_torch.core.unwrapped import UnwrappedADMM
from repro_torch.data import synthetic
from repro_torch.device import resolve_device

# flag -> ROADMAP item that ports it
NOT_PORTED = {
    "--method": 5, "--heterogeneous": 4, "--mu": 4, "--workers": 9,
    "--multi-device": 8, "--streaming": 7, "--device-budget-mb": 7,
    "--store-dir": 7, "--cluster": 9, "--cluster-compress": 9,
    "--cluster-staleness": 9, "--chaos-seed": 9, "--chaos-spec": 9,
    "--min-quorum": 9, "--iter-deadline": 9, "--checkpoint-dir": 7,
    "--checkpoint-every": 7, "--resume": 7, "--density": 6,
    "--sparse-format": 6, "--obs-dir": 10,
}
EXECUTOR_ITEMS = {"streaming": 7, "shard_map": 8, "cluster": 9}
PROBLEM_ITEMS = {"lasso": 4, "sparse_logistic": 4}


def _admm_params(problem):
    """(loss, rho, tau) — the JAX CLI's one table for the separable-loss
    ADMM paths."""
    if problem == "logistic":
        return make_logistic(), 0.0, 0.1
    return make_hinge(1.0), 1.0, 0.5          # svm, C = 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="logistic",
                    choices=["logistic", "svm", "lasso", "sparse_logistic"])
    ap.add_argument("--executor", default="local",
                    choices=["local", "streaming", "shard_map", "cluster"])
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--rows-per-node", type=int, default=5000)
    ap.add_argument("--features", type=int, default=200)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the solve runs (default cuda; cpu on ask)")
    for flag in NOT_PORTED:
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    for flag, item in NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            raise SystemExit(f"{flag} is not ported yet (ROADMAP item "
                             f"{item})")
    if args.executor != "local":
        raise SystemExit(f"--executor {args.executor} is not ported yet "
                         f"(ROADMAP item {EXECUTOR_ITEMS[args.executor]})")
    if args.problem in PROBLEM_ITEMS:
        raise SystemExit(f"--problem {args.problem} is not ported yet "
                         f"(ROADMAP item {PROBLEM_ITEMS[args.problem]})")

    dev = resolve_device(args.device)
    N, mi, n = args.nodes, args.rows_per_node, args.features
    t0 = time.time()
    prob = synthetic.classification_problem(args.seed, N, mi, n, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"data: {N} nodes x {mi} rows x {n} features "
          f"({N*mi*n*4/2**30:.2f} GiB) on {dev} in {time.time()-t0:.1f}s",
          flush=True)

    loss, rho, tau = _admm_params(args.problem)
    solver = UnwrappedADMM(loss=loss, tau=tau, rho=rho, device=str(dev))
    t0 = time.time()
    res = solver.solve(prob.D, prob.labels, max_iters=args.iters)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"[transpose] {args.problem}: {res.iters} iters in {dt:.1f}s",
          flush=True)

    D2 = prob.D.reshape(-1, n)
    a2 = prob.labels.reshape(-1)
    Dx = D2 @ res.x
    if args.problem == "logistic":
        obj = float(torch.sum(torch.logaddexp(
            -a2 * Dx, torch.zeros((), device=dev))))
        acc = float(torch.mean((torch.sign(Dx) == a2).float()))
        print(f"objective: {obj:.2f}, train acc: {acc:.4f}")
    else:
        obj = float(torch.sum(torch.clamp(1.0 - a2 * Dx, min=0.0))
                    + 0.5 * torch.sum(res.x * res.x))
        print(f"objective: {obj:.2f}")
    return res


if __name__ == "__main__":
    main()
