"""Training launcher; port of ``repro/launch/train.py``.

``python -m repro_torch.launch.train --arch qwen3-8b --smoke --device cpu
     --steps 24 --batch 2 --seq 32``

Runs real steps on one device (``--device`` defaults to ``cuda`` and
raises without a GPU; ``--smoke`` takes the reduced same-family config).
The full fault-tolerance loop: the deterministic data pipeline, periodic
atomic checkpoints of ``(params, opt_state)`` written on a background
thread, resume from the latest one, and failure injection
(``--die-at-step``: SIGKILL after the pending checkpoint is on disk) for
the restart tests. Parameters are random, drawn from ``--seed`` by a
``torch.Generator`` on the device. The train step takes the chunked
attention and WKV paths (the kernels have no backward).

Each step ends in a device synchronize (its loss is read on the host), so
a step's host-clock time, from making its batch to reading its loss, is
its device time plus dispatch. The last line gives the median over the
steps after the first two; ``main`` returns the losses, the gradient
norms (before clipping) and the step times.
"""
from __future__ import annotations

import argparse
import os
import signal
import statistics
import time

import torch

import repro_torch.configs as configs_lib
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import TokenPipeline, place
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.runtime.steps import make_train_step

WARMUP_STEPS = 2        # steps left out of the median step time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--die-at-step", type=int, default=-1,
                    help="failure injection: SIGKILL self at this step")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs_lib.get_smoke(args.arch) if args.smoke \
        else configs_lib.get(args.arch)
    opt = make_optimizer(cfg.optimizer, lr=args.lr,
                         total_steps=max(args.steps, 2))
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches)

    pipe = TokenPipeline(vocab_size=cfg.vocab_size, global_batch=args.batch,
                         seq_len=args.seq, seed=args.seed,
                         frontend=cfg.frontend, d_model=cfg.d_model,
                         mrope=cfg.mrope)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed))
    opt_state = opt.init(params)
    if ckpt and ckpt.latest_step() is not None:
        (params, opt_state), extra = ckpt.restore((params, opt_state))
        start = extra["step"] + 1
        print(f"[resume] restored step {extra['step']}, continuing at {start}",
              flush=True)

    losses, grad_norms, step_s = [], [], []
    t0 = time.time()
    for step in range(start, args.steps):
        t_step = time.perf_counter()
        batch = place(pipe.batch_at(step), dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        loss = float(metrics["loss"])      # a device synchronize
        step_s.append(time.perf_counter() - t_step)
        losses.append(loss)
        grad_norms.append(float(metrics["grad_norm"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {grad_norms[-1]:.3f} "
                  f"({(time.time()-t0):.1f}s)", flush=True)
        if ckpt and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step, (params, opt_state), extra={"step": step},
                      background=True)
        if args.die_at_step == step:
            print(f"[failure-injection] SIGKILL at step {step}", flush=True)
            if ckpt:
                ckpt.wait()
            os.kill(os.getpid(), signal.SIGKILL)
    if ckpt:
        ckpt.wait()  # drain any background save before the final one
        if ckpt.latest_step() != args.steps - 1:
            ckpt.save(args.steps - 1, (params, opt_state),
                      extra={"step": args.steps - 1})
        ckpt.wait()
    print(f"[done] final loss {losses[-1]:.4f} (first {losses[0]:.4f}); "
          f"exact {losses[-1]!r}", flush=True)
    timed = step_s[WARMUP_STEPS:]
    if timed:
        ms = statistics.median(timed) * 1e3
        print(f"[time] median step {ms:.2f} ms over {len(timed)} steps "
              f"after the first {WARMUP_STEPS}; "
              f"{args.batch * args.seq / ms * 1e3:.1f} tok/s", flush=True)
    return {"losses": losses, "grad_norms": grad_norms, "step_s": step_s}


if __name__ == "__main__":
    main()
