"""Serving launcher: batched prefill + decode on one device; port of
``repro/launch/serve.py``.

``python -m repro_torch.launch.serve --arch qwen3-8b --smoke --device cpu
     --batch 2 --prompt-len 16 --gen 4``

``--device`` defaults to ``cuda`` and raises without a GPU. Weights and
prompt tokens are random, drawn from ``--seed`` by a ``torch.Generator``
on the device. Times are host-clock seconds around work that ends in a
device synchronize.
"""
from __future__ import annotations

import argparse
import time

import torch

import repro_torch.configs as configs_lib
from repro_torch.device import resolve_device
from repro_torch.models.decode import prefill
from repro_torch.models.model import init_params
from repro_torch.runtime.steps import make_serve_step


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs_lib.get_smoke(args.arch) if args.smoke \
        else configs_lib.get(args.arch)
    gen_rng = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen_rng)
    B, S = args.batch, args.prompt_len
    s_max = S + args.gen
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen_rng,
                           device=dev)

    step = make_serve_step(cfg)
    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = prefill(params, cfg, tokens=tokens, s_max=s_max)
        out = [torch.argmax(logits, -1)]
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(args.gen - 1):
            logits, caches = step(params, caches, out[-1], S + i)
            if args.temperature > 0:
                probs = torch.softmax(logits / args.temperature, -1)
                out.append(torch.multinomial(probs, 1, generator=gen_rng)[:, 0])
            else:
                out.append(torch.argmax(logits, -1))
        gen = torch.stack(out, dim=1)
        _sync(dev)
        dt = time.perf_counter() - t0
    steps = args.gen - 1
    print(f"prefill {B}x{S}: {t_prefill:.2f}s; "
          f"decode {steps} steps: {dt:.2f}s "
          f"({B * steps / max(dt, 1e-9):.1f} tok/s, "
          f"{dt * 1e3 / max(steps, 1):.2f} ms/step)")
    print("generated:", gen[0][:16].tolist())
    return gen


if __name__ == "__main__":
    main()
