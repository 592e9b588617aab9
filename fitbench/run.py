"""Run one cell of the port's benchmark once and print its result line.

    python3 fitbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic and
metrics are read from ``BENCHMARK.json``. With ``--trace 0`` the result
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics read from the profiler's trace of the window. The last line of
standard output is one JSON object; the last lines of standard error are
the numbers compared with the reference, each beside its limit. Without
as many CUDA devices as the cell asks for, it exits with code 2 and prints
no result; where this process or any rank of the cell holds a module of
JAX or the JAX package once the window has closed, it exits with code 3,
names the modules and prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# kernel and compiler caches at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}


def forbidden_found(out: dict) -> dict:
    """The modules of JAX or the JAX package that each rank of the run held
    once the window had closed (``out["forbidden"]``), with this process's
    own as rank 0's; empty when none did."""
    from fitbench import harness
    found = dict(out.get("forbidden") or {})
    mine = harness.loaded_forbidden()
    if mine:
        found["0"] = sorted(set(found.get("0", [])) | set(mine))
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "fitbench" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from fitbench import card, harness, manifest
    bench = manifest.load(ROOT / "BENCHMARK.json")
    chips = int(manifest.cell(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"fitbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda", bench=bench,
                           t0=T0)
    bad = forbidden_found(out)
    if bad:
        print(f"fitbench: modules of JAX or the JAX package loaded, by "
              f"rank: {bad}", file=sys.stderr)
        return 3
    del out["forbidden"]
    out["device"]["power_limit"] = card.name_and_limit()
    checks = out.pop("checks")
    out["checks"] = checks
    print(json.dumps(out), flush=True)
    print(f"card: {out['device']['power_limit']}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
