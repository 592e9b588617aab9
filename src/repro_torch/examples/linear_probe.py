"""ADMM x LM-framework composition: fit a readout head on FROZEN
transformer features with transpose-reduction ADMM; port of
``examples/linear_probe.py``.

Trains a small qwen3-family LM for a few steps, extracts residual-stream
features, teaches a sparse logistic probe to recover a feature-linear
labeling — the 'linear probe at 950M-rows scale' workflow, miniaturized.

    PYTHONPATH=src python -m repro_torch.examples.linear_probe [--device cpu] [--smoke]
"""
import argparse
import json
import time

import numpy as np
import torch

import repro_torch.configs as configs_lib
from repro_torch.core.fit import fit
from repro_torch.device import resolve_device
from repro_torch.models.model import forward, init_params
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.runtime.steps import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="5 LM steps instead of 20")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = configs_lib.get_smoke("qwen3-8b")
    g = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, g)

    # a few LM steps so features are not pure init noise
    steps = 5 if args.smoke else 20
    opt = make_optimizer("adamw", lr=3e-3, warmup_steps=1, total_steps=30)
    step = make_train_step(cfg, opt)
    opt_state = opt.init(params)
    tokens = torch.randint(0, cfg.vocab_size, (8, 64), generator=g,
                           device=dev)
    batch = {"tokens": tokens, "labels": tokens}
    for i in range(steps):
        params, opt_state, m = step(params, opt_state, batch, i)
    print(f"warmed up LM ({cfg.d_model}d): loss {float(m['loss']):.3f}")

    # frozen features -> node-stacked D for the ADMM fitter
    with torch.no_grad():
        h, _ = forward(params, cfg, tokens=tokens)
    feats = h.reshape(-1, cfg.d_model).float().cpu().numpy()
    feats /= np.linalg.norm(feats, axis=1, keepdims=True) + 1e-6
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal(cfg.d_model)
    labels = np.sign(feats @ w_true
                     + 0.1 * rng.standard_normal(len(feats)))
    D = torch.from_numpy(feats).reshape(4, -1, cfg.d_model)
    aux = torch.from_numpy(labels.astype(np.float32)).reshape(4, -1)

    t0 = time.time()
    r = fit("sparse_logistic", D, aux, mu=0.5, iters=200, device=dev)
    x = r.x.cpu().numpy()
    acc = float(np.mean(np.sign(feats @ x) == labels))
    nnz = int((np.abs(x) > 1e-5).sum())
    print(f"sparse logistic probe: {time.time()-t0:.1f}s, "
          f"train acc {acc:.3f}, {nnz}/{cfg.d_model} features used")
    assert acc > 0.9
    print(json.dumps({"example": "linear_probe", "train_acc": acc,
                      "features_used": nnz}))


if __name__ == "__main__":
    main()
