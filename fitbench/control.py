"""Readings for the limits of ``correct``, on the cards: for each seed, the
data made once, one fit of the program as configured and one of its
control (the program with its bf16 path switched on), each after a warm
fit, both judged against one run of the plain reference, as a benchmark
run judges its fits.

    python3 fitbench/control.py --workload star-logistic --seeds 11 12 13

prints one JSON line a seed: every number the reference's judge gives for
each side (over several ranks, each number's worst over the ranks, and
``rank_gap``), each side's fit time, and the reference's own diagnostics.
A cell on several chips starts its ranks once and reads every seed on them.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CONTROL = {"residency": "bf16"}


def readings(w, seeds, device, rank=None):
    """One reading a seed; over several ranks this rank's part, on a group
    joined once. Rank 0 (or the one process) prints them."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    if rank is None:
        return _read(w, seeds, torch.device(device), None)
    from repro_torch.sharding import compat
    with compat.make_group(device=device) as group, compat.use_group(group):
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        _read(w, seeds, dev, group)


def _read(w, seeds, dev, group):
    import torch
    import torch.distributed as dist

    from fitbench import harness, manifest
    first = group is None or group.rank == 0
    cfg = w["cfg"]
    ref_mod = manifest.module("reference", cfg["reference"])
    for seed in seeds:
        inputs = manifest.module("data", cfg["data"]).make(cfg, seed, dev)
        out = {"seed": seed}
        answers = {}
        for side, extra in (("program", {}), ("control", CONTROL)):
            fit = manifest.module("systems", cfg["system"]).prepare(
                {**cfg, **extra}, inputs, dev, group)
            fit({})
            harness._sync(dev)
            t = time.perf_counter()
            a = fit({})
            harness._sync(dev)
            out[f"{side}_s"] = time.perf_counter() - t
            answers[side] = {k: v.cpu() if torch.is_tensor(v) else v
                             for k, v in a.items()}
            del fit, a
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        t = time.perf_counter()
        ref = ref_mod.solve(cfg, inputs, dev)
        out["reference_s"] = time.perf_counter() - t
        out["reference"] = {k: v for k, v in ref.items()
                            if not torch.is_tensor(v)}
        for side, a in answers.items():
            every = [a]
            if group is not None:
                every = [None] * group.world if first else None
                dist.gather_object(a, every, dst=0)
            if first:
                out[side] = harness.judge_ranks(cfg, ref_mod, ref,
                                                [[x] for x in every])[0]
        del inputs, ref
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if first:
            print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from fitbench import manifest, ranks
    w = manifest.cell(manifest.load(), args.workload)
    if torch.cuda.device_count() < int(w["chips"]):
        print("fitbench: control readings need the cell's CUDA devices",
              file=sys.stderr)
        return 2
    if int(w["chips"]) == 1:
        readings(w, args.seeds, "cuda")
    else:
        ranks.run(int(w["chips"]), readings, (w, args.seeds, "cuda"),
                  join_timeout=600.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
