"""Print the largest collectives of a one-layer step — the hypothesis
generator for collective traffic; port of ``scripts/diagnose_collectives.py``.

The reference reads them from a compiled module's HLO. The port has none,
so it prints two lists instead:

  * recorded — the collectives the port actually issues: the arch's
    one-layer config runs ``model.forward`` on a (1 x ``--ranks``) grid of
    gloo ranks (on the CPU or sharing the card) under the collective
    recorder. The port's only LM collectives are the a2a path's
    (``models.moe_a2a``): a dense arch issues none.
  * modeled — the dry-run's layout rules (``launch.dryrun``) for the
    one-layer step at ``--shape`` on the 16 x 16 production grid.

    PYTHONPATH=src python -m repro_torch.launch.diagnose_collectives --arch olmoe-1b-7b [--shape train_4k] [--device cpu] [--smoke]

``--smoke`` takes the arch's smoke config and a 2 x 32 batch for the
recorded run (the full config otherwise, at 2 x 256 tokens).
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

import repro_torch.configs as configs_lib
from repro_torch.device import resolve_device
from repro_torch.launch import dryrun
from repro_torch.launch.input_specs import SHAPES
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import hlo
from repro_torch.sharding import compat
from repro_torch.sharding import specs as spec_lib


def _one_layer(cfg, layers: int):
    kw = dict(num_layers=layers)
    if cfg.family == "encdec":
        kw["encoder_layers"] = layers
    return dataclasses.replace(cfg, **kw)


def recorded(cfg, ranks: int, device, B: int, S: int):
    """The collectives one rank issues in ``model.forward`` on a (1 x
    ranks) grid (rank 0's records)."""
    import torch

    from repro_torch.models import moe_a2a
    from repro_torch.models.model import init_params

    params = init_params(cfg, torch.Generator().manual_seed(0))
    # numpy (f32) for the ranks: each unpickles its own copy
    tree = spec_lib.tree_map(lambda t: t.float().numpy(), params)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    case = dict(kind="forward", cfg=cfg, params=tree, tokens=tokens,
                grid=((1, ranks), ("data", "model")))
    backend = compat.layout_backend(device, ranks)
    out = compat.spawn(moe_a2a.rank_cases, ranks, backend,
                       args=([case], device.type), device=device.type,
                       threads=1 if device.type == "cpu" else None)
    return out[0][0]["ops"]


def _print(title, ops, top):
    st = hlo.stats(ops)
    print(f"== {title}: {len(ops)} collectives, sum(out bytes)="
          f"{sum(o['bytes'] for o in ops) / 2**20:.2f} MiB, wire "
          f"{st.wire_bytes / 2**20:.2f} MiB by kind "
          f"{ {k: round(v / 2**20, 3) for k, v in st.by_kind().items()} }")
    for o in sorted(ops, key=lambda o: -o["bytes"])[:top]:
        print(f"{o['bytes'] / 2**20:10.3f} MiB  {o['kind']:18s} "
              f"g={o['group']:3d}  {o['what']}")
    return st


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--ranks", type=int, default=2,
                    help="the 'model' line of the recorded run")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    get = configs_lib.get_smoke if args.smoke else configs_lib.get
    cfg1 = _one_layer(get(args.arch), args.layers)
    B, S = (2, 32) if args.smoke else (2, 256)
    rec = recorded(cfg1, args.ranks, dev, B, S)
    st_rec = _print(f"recorded: {args.arch} L={args.layers} forward "
                    f"{B}x{S} on 1 x {args.ranks} ranks ({dev.type})", rec,
                    args.top)

    grid = make_production_mesh(multi_pod=False)
    fn, a, info = dryrun.build_cell(args.arch, args.shape, grid,
                                    cfg_override=cfg1)
    step = SHAPES[args.shape]["kind"]
    model = dryrun.layout_collectives(info["cfg"], grid, step, info["B"],
                                      info["S"], info["params"],
                                      info["tp_pspec"])
    st_mod = _print(f"modeled: {args.arch} {args.shape} L={args.layers} on "
                    f"{dryrun._mesh_name(grid)} (layout rules)", model,
                    args.top)
    print(json.dumps({"arch": args.arch, "shape": args.shape,
                      "recorded_ops": len(rec),
                      "recorded_wire_bytes": st_rec.wire_bytes,
                      "modeled_ops": len(model),
                      "modeled_wire_bytes": st_mod.wire_bytes}))


if __name__ == "__main__":
    main()
