"""Quickstart: the paper in 60 seconds; port of ``examples/quickstart.py``.

Fits a lasso by transpose reduction (Gram + single-node FASTA), checks
the KKT certificate, and races unwrapped ADMM against consensus ADMM on a
heterogeneous logistic problem (the paper's headline comparison).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu] [--smoke]
"""
import argparse
import json
import time

import numpy as np

from repro_torch.core import gram_and_rhs_chunked, transpose_reduction_lasso
from repro_torch.core.fit import fit
from repro_torch.core.oracles import (
    lasso_kkt_gap,
    logistic_objective,
    newton_logistic,
)
from repro_torch.data.synthetic import classification_problem, lasso_problem
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="a small problem (seconds on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    N, m_per, n = (4, 500, 40) if args.smoke else (8, 2000, 100)
    iters = 60 if args.smoke else 150

    # --- 1. Lasso via transpose reduction (paper §4) -----------------------
    prob = lasso_problem(0, N=N, m_per_node=m_per, n=n, device=dev)
    Dflat = prob.D.reshape(-1, n)
    b = prob.b.reshape(-1)
    print(f"lasso: D is {Dflat.shape[0]}x{n} over {N} nodes, "
          f"mu = {float(prob.mu):.2f} (10% rule)")
    t0 = time.time()
    G, c = gram_and_rhs_chunked(Dflat, b)                 # ONE data pass
    res = transpose_reduction_lasso(G, c, float(prob.mu), iters=2000)
    dt = time.time() - t0
    viol, _ = lasso_kkt_gap(Dflat.cpu().numpy(), b.cpu().numpy(),
                            res.x.cpu().numpy(), float(prob.mu))
    nnz = int((res.x.abs() > 1e-6).sum())
    print(f"  solved in {dt:.2f}s ({int(res.iters)} FASTA iters); "
          f"KKT violation {viol:.1e}; support {nnz} (true 10)")

    # --- 2. Unwrapped ADMM vs consensus on heterogeneous data (§10) --------
    prob = classification_problem(0, N=N, m_per_node=m_per, n=n,
                                  heterogeneity=1.0, device=dev)
    D2 = prob.D.reshape(-1, n).cpu().numpy()
    l2 = prob.labels.reshape(-1).cpu().numpy()
    obj_star = logistic_objective(D2, l2, newton_logistic(D2, l2))
    hits = {}
    for method in ("transpose", "consensus"):
        t0 = time.time()
        r = fit("logistic", prob.D, prob.labels, method=method, iters=iters,
                device=dev)
        objs = r.objective_history.cpu().numpy()
        hit = np.nonzero(objs <= obj_star * 1.001)[0]
        hits[method] = int(hit[0]) + 1 if len(hit) else None
        it = hits[method] if hits[method] else f">{len(objs)}"
        print(f"  {method:10s}: {time.time()-t0:5.1f}s wall, "
              f"iterations to 0.1% of optimum: {it}")
    print("transpose reduction wins; the gap grows with heterogeneity "
          "(paper Fig. 2b).")
    print(json.dumps({"example": "quickstart", "device": str(dev),
                      "lasso_kkt": viol, "lasso_support": nnz,
                      "iters_to_optimum": hits}))


if __name__ == "__main__":
    main()
