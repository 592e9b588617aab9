"""Serving linear probes on frozen LM features from ONE Gram pass; port of
``examples/probe_server.py``.

An interpretability / evals workload wants many readout heads on the same
frozen transformer features — per-label probes, a regularization path.
Per-probe ``fit()`` would recompute the Gram every time; the serving layer
registers the features ONCE and answers every probe from the cached
sufficient statistic.

    PYTHONPATH=src python -m repro_torch.examples.probe_server [--device cpu] [--smoke]
"""
import argparse
import json
import time

import numpy as np
import torch

import repro_torch.configs as configs_lib
from repro_torch.device import resolve_device
from repro_torch.models.model import forward, init_params
from repro_torch.service.batching import lasso_mu_path
from repro_torch.service.server import FitRequest, FitServer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="8 probes on 4 x 32 tokens")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_probes, B, S = (8, 4, 32) if args.smoke else (32, 8, 64)
    cfg = configs_lib.get_smoke("qwen3-8b")
    g = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, g)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           device=dev)

    # frozen features: the dataset every probe shares
    with torch.no_grad():
        h, _ = forward(params, cfg, tokens=tokens)
    feats = h.reshape(-1, cfg.d_model).float().cpu().numpy()
    feats /= np.linalg.norm(feats, axis=1, keepdims=True) + 1e-6
    m, n = feats.shape
    print(f"frozen features: {m} tokens x {n}d")

    srv = FitServer(window=n_probes, device=dev)
    t0 = time.time()
    fp = srv.register_dataset(torch.from_numpy(feats).to(dev))
    print(f"registered in {time.time()-t0:.2f}s — the only Gram pass")

    # one synthetic ground-truth direction per probe
    rng = np.random.default_rng(0)
    W = rng.standard_normal((n_probes, n)).astype(np.float32)
    targets = feats @ W.T + 0.1 * rng.standard_normal(
        (m, n_probes)).astype(np.float32)

    reqs = [FitRequest(problem="ridge", fingerprint=fp, b=targets[:, j],
                       mu=1e-3 * m) for j in range(n_probes)]
    t0 = time.time()
    resp = srv.serve(reqs)
    dt = time.time() - t0
    X = np.stack([r.x for r in sorted(resp, key=lambda r: r.request_id)])
    cos = np.sum(X * W, axis=1) / (
        np.linalg.norm(X, axis=1) * np.linalg.norm(W, axis=1))
    print(f"{n_probes} ridge probes served in {dt:.2f}s "
          f"({dt/n_probes*1e3:.1f} ms/probe), batch={resp[0].batch_size}; "
          f"probe/truth cosine: min {cos.min():.3f} mean {cos.mean():.3f}")
    assert cos.min() > 0.9

    # sparse readout: full lasso path for probe 0, same cached Gram
    stats = srv.stats_for(fp)
    c0 = torch.from_numpy(feats.T @ targets[:, 0]).to(stats.G.device)
    mus = torch.logspace(-1, 2, 16) * float(c0.abs().max()) / 100.0
    t0 = time.time()
    Xp = lasso_mu_path(stats.G, c0, mus, iters=400)
    nnz = (Xp.abs() > 1e-5).sum(dim=1).cpu().numpy()
    print(f"lasso path (16 mus) in {time.time()-t0:.2f}s; "
          f"support {nnz[0]} -> {nnz[-1]}")

    c = srv.counters.snapshot()
    print("counters:", c)
    assert c["gram_passes"] == 1, "probes must share the single Gram pass"
    print(json.dumps({"example": "probe_server", "probes": n_probes,
                      "min_cosine": float(cos.min()),
                      "gram_passes": c["gram_passes"]}))


if __name__ == "__main__":
    main()
