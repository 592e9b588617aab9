"""Distributed end-to-end driver (the paper's kind of production run);
port of ``examples/distributed_fit.py``: row-shard a synthetic corpus over
the ranks of a process group (one rank a card, or gloo ranks on the CPU),
run transpose-reduction ADMM — one n-vector all-reduce per iteration —
and validate against the single-node oracle.

    PYTHONPATH=src python -m repro_torch.examples.distributed_fit [--device cpu] [--ranks 8] [--smoke]
"""
import argparse
import json
import time

import numpy as np

from repro_torch.core.distributed import solve_rank
from repro_torch.core.oracles import logistic_objective, newton_logistic
from repro_torch.data.synthetic import classification_problem
from repro_torch.device import resolve_device
from repro_torch.sharding import compat


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=0,
                    help="ranks (default: one per card; 8 on the CPU)")
    ap.add_argument("--smoke", action="store_true",
                    help="2 ranks, a small corpus")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ranks = args.ranks or (2 if args.smoke else (
        compat.local_world(dev) if dev.type == "cuda" else 8))
    backend = compat.layout_backend(dev, ranks)
    print(f"ranks: {ranks} on {dev.type} ({backend}), each a paper 'node'")

    m_per, n, iters = (2000, 20, 40) if args.smoke else (25_000, 200, 80)
    prob = classification_problem(0, N=ranks, m_per_node=m_per, n=n,
                                  heterogeneity=1.0, device="cpu")
    D2 = prob.D.reshape(-1, n).numpy()
    l2 = prob.labels.reshape(-1).numpy()
    print(f"corpus: {D2.shape[0]:,} x {n} ({D2.nbytes / 2**30:.2f} GiB), "
          f"heterogeneous nodes")
    calls = [dict(loss={"name": "logistic"}, D=D2, aux=l2, iters=iters,
                  tau=0.1)]
    t0 = time.time()
    out = compat.spawn(solve_rank, ranks, backend, args=(calls, dev.type),
                       device=dev.type, threads=1 if dev.type == "cpu"
                       else None)
    dt = time.time() - t0
    x = out[0][0]["x"]
    objs = out[0][0]["objective"]
    obj_star = logistic_objective(D2, l2, newton_logistic(D2, l2))
    obj = float(objs[-1])
    acc = float(np.mean(np.sign(D2 @ x) == l2))
    print(f"{iters} ADMM iterations in {dt:.1f}s (spawn included); "
          f"objective {obj:.1f} (optimum {obj_star:.1f}, gap "
          f"{obj - obj_star:.2e}); train acc {acc:.3f}")
    print("per-iteration network traffic: ONE all-reduce of "
          f"{n} floats per node (the paper's O(n) claim).")
    print(json.dumps({"example": "distributed_fit", "ranks": ranks,
                      "backend": backend, "objective": obj,
                      "optimum": obj_star, "train_acc": acc}))


if __name__ == "__main__":
    main()
