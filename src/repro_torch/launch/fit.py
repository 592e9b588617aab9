"""GLM fitting launcher — the paper's end-to-end fitting program; port of
``repro/launch/fit.py`` for ``--executor local``.

``python -m repro_torch.launch.fit --problem lasso --nodes 320
     --rows-per-node 50000 --features 200 --heterogeneous``

The data come from the port's generators (``lasso_problem`` for lasso,
``classification_problem`` otherwise) and the solve is ``fit()`` with
``--method transpose`` (the paper), ``consensus`` (the Boyd baseline) or
``fasta`` (lasso: the same Gram path), as in the JAX CLI. It runs on the
card (``--device cuda``) unless asked for the CPU; the result lines
(lasso: the KKT violation and support error; logistic: objective and
training accuracy; SVM: objective) are computed on the device, in float64
sums over row blocks, without a host copy of D. The JAX CLI's other flags
exit with the ROADMAP item that ports them.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.fit import fit as fit_glm
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.exec.problems import EXECUTOR_ITEMS

# flag -> ROADMAP item that ports it
NOT_PORTED = {
    "--workers": 9, "--multi-device": 8, "--streaming": 7,
    "--device-budget-mb": 7, "--store-dir": 7, "--cluster": 9,
    "--cluster-compress": 9, "--cluster-staleness": 9, "--chaos-seed": 9,
    "--chaos-spec": 9, "--min-quorum": 9, "--iter-deadline": 9,
    "--checkpoint-dir": 7, "--checkpoint-every": 7, "--resume": 7,
    "--density": 6, "--sparse-format": 6, "--obs-dir": 10,
}
BLOCK_ROWS = 1 << 20


def _blocks(D2: torch.Tensor, v: torch.Tensor):
    for s in range(0, D2.shape[0], BLOCK_ROWS):
        yield D2[s:s + BLOCK_ROWS], v[s:s + BLOCK_ROWS]


def lasso_kkt_gap(D2: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                  mu: float):
    """``oracles.lasso_kkt_gap`` on the data's device: (inf-norm violation,
    support error) of the lasso optimality conditions, with
    D^T(Dx - b) summed in float64 over row blocks."""
    x64 = x.double()
    corr = torch.zeros_like(x64)
    for Db, bb in _blocks(D2, b):
        Db = Db.double()
        corr += Db.T @ (Db @ x64 - bb.double())
    viol = max(float(torch.max(torch.abs(corr))) - mu, 0.0)
    sup = torch.abs(x64) > 1e-7
    sup_err = float(torch.max(torch.abs(corr[sup] + mu * torch.sign(
        x64[sup])))) if bool(sup.any()) else 0.0
    return viol, sup_err


def classifier_summary(D2: torch.Tensor, a: torch.Tensor, x: torch.Tensor):
    """(sum softplus(-a Dx), sum hinge(1 - a Dx), training accuracy) on
    the device, in float64 sums over row blocks."""
    x64 = x.double()
    logi = hinge = hits = 0.0
    zero = torch.zeros((), dtype=torch.float64, device=D2.device)
    for Db, ab in _blocks(D2, a):
        z = Db.double() @ x64
        ab = ab.double()
        logi += float(torch.sum(torch.logaddexp(zero, -ab * z)))
        hinge += float(torch.sum(torch.clamp(1.0 - ab * z, min=0.0)))
        hits += float(torch.sum(torch.sign(z) == ab))
    return logi, hinge, hits / D2.shape[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="logistic",
                    choices=["lasso", "logistic", "svm", "sparse_logistic"])
    ap.add_argument("--method", default="transpose",
                    choices=["transpose", "consensus", "fasta"])
    ap.add_argument("--executor", default="local",
                    choices=["local", "streaming", "shard_map", "cluster"])
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--rows-per-node", type=int, default=5000)
    ap.add_argument("--features", type=int, default=200)
    ap.add_argument("--heterogeneous", action="store_true")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--mu", type=float, default=None)
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

    dev = resolve_device(args.device)
    N, mi, n = args.nodes, args.rows_per_node, args.features
    het = 1.0 if args.heterogeneous else 0.0
    t0 = time.time()
    if args.problem == "lasso":
        prob = synthetic.lasso_problem(args.seed, N, mi, n,
                                       heterogeneity=het, device=dev)
        D, aux = prob.D, prob.b
        mu = args.mu if args.mu is not None else float(prob.mu)
    else:
        prob = synthetic.classification_problem(args.seed, N, mi, n,
                                                heterogeneity=het,
                                                device=dev)
        D, aux = prob.D, prob.labels
        mu = args.mu if args.mu is not None else 1.0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"data: {N} nodes x {mi} rows x {n} features "
          f"({N*mi*n*4/2**30:.2f} GiB) on {dev} in {time.time()-t0:.1f}s",
          flush=True)

    t0 = time.time()
    res = fit_glm(args.problem, D, aux, method=args.method,
                  mu=mu if args.problem in ("lasso", "sparse_logistic")
                  else None, iters=args.iters, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"[{args.method}] {args.problem}: {res.iters} iters in {dt:.1f}s",
          flush=True)

    D2, a2 = D.reshape(-1, n), aux.reshape(-1)
    if args.problem == "lasso":
        viol, sup = lasso_kkt_gap(D2, a2, res.x, mu)
        print(f"KKT violation: {viol:.2e}, support err: {sup:.2e}")
    else:
        logi, hinge, acc = classifier_summary(D2, a2, res.x)
        if args.problem in ("logistic", "sparse_logistic"):
            print(f"objective: {logi:.2f}, train acc: {acc:.4f}")
        else:
            x64 = res.x.double()
            obj = hinge + 0.5 * float(torch.dot(x64, x64))
            print(f"objective: {obj:.2f}")
    return res


if __name__ == "__main__":
    main()
