"""Production dry-run: count every (arch x shape x grid) cell on the meta
device and model its per-device memory and collective traffic for the
roofline; port of ``repro/launch/dryrun.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out artifacts/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --fit-cell star_f32

Nothing runs on a device and nothing is allocated: parameters, optimizer
state, batches and caches are meta tensors (``launch.input_specs``). Per
cell:

  * FLOPs and bytes: the GLOBAL step (train step, prefill, or one decode
    step) runs on the meta device under ``roofline.hlo.OpCounter``; the
    per-device numbers are the global ones over the card count (the work
    of a sharded step split evenly). Bytes are an unfused count (see
    ``roofline.hlo``). A Python loop over the layers is counted layer by
    layer, so the reference's L-extrapolation is not needed; ``per_unit``
    and ``non_layer`` come from one more count at one layer unit.
  * Per-device memory: params, optimizer state, batch and caches summed
    under the spec trees (``sharding.specs``). Activations and
    temporaries are left out (``memory_model`` in the JSON says so).
  * Collectives: a MODEL, not a measurement. The port runs no tensor-
    parallel LM step (the JAX package only lowers one), so the traffic
    comes from explicit layout rules, each a small function below:
    ``rule_dp`` (ZeRO-1 / FSDP gradient reduce-scatter and parameter
    all-gather over DP), ``rule_tp`` (a TP-sharded layer's activation
    all-reduce, or the sequence-parallel reduce-scatter / all-gather
    pair) and ``rule_ep`` (the a2a hops of ``models.moe_a2a``,
    2 x Csend x M x d x dtype plus the expert ids, and the line's
    all-gather). Each group is timed at NVLink's rate within a node of 8
    cards and at InfiniBand's across nodes.

The fit cells (``--fit-cell``) count one rank's ADMM programs
(``launch.fit_cell``); their all-reduces are recorded as issued, on a fake
process group. ``lower_s`` and ``compile_s`` have no counterpart.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Dict, List

import torch

import repro_torch.configs as configs_lib
from repro_torch.launch import input_specs as specs_mod
from repro_torch.launch.fit_cell import CELLS, build_fit_cell, fake_group
from repro_torch.launch.input_specs import SHAPES, abstract_params, \
    input_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import moe_a2a
from repro_torch.models.decode import init_caches
from repro_torch.models.decode import prefill as prefill_fn
from repro_torch.models.model import layer_kinds
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.roofline import hlo
from repro_torch.roofline.hlo import record, roofline_terms
from repro_torch.runtime.steps import make_serve_step, make_train_step
from repro_torch.sharding import specs as spec_lib
from repro_torch.sharding.util import DP

ARCHES = [
    "arctic-480b", "olmoe-1b-7b", "rwkv6-1.6b", "qwen3-14b",
    "command-r-35b", "phi3-medium-14b", "qwen3-8b",
    "seamless-m4t-large-v2", "qwen2-vl-72b", "recurrentgemma-9b",
]

MEMORY_MODEL = ("params + optimizer state + batch + caches under the spec "
                "trees; activations and temporaries not included")
COLLECTIVE_MODEL = ("layout rules (rule_dp, rule_tp, rule_ep): a model of "
                    "a sharded step's traffic, not a measurement")


def _mesh_name(grid) -> str:
    return "x".join(str(s) for s in grid.shape)


def line_ranks(grid, axes) -> List[int]:
    """The ranks of rank 0's group over ``axes`` (those sharing its
    coordinates on every other axis)."""
    axes = tuple(a for a in axes if a in grid.axes)
    keep = [i for i, a in enumerate(grid.axes) if a not in axes]
    return [r for r in range(grid.size)
            if all(grid.coords_of(r)[i] == 0 for i in keep)]


def _dp_axes(cfg, grid):
    return tuple(a for a in cfg.dp_axes if a in grid.axes)


def _passes(cfg, kind: str) -> int:
    """How often a step runs a layer's forward collectives: once in
    serving; in training once forward, once backward (the transposed
    collective), and once more in the remat recompute."""
    if kind != "train":
        return 1
    return 2 + (cfg.remat != "none")


# ---------------------------------------------------------------------------
# layout rules
# ---------------------------------------------------------------------------

def rule_dp(cfg, grid, params, pspec) -> List[Dict]:
    """ZeRO-1 or FSDP over the DP axes (training only), per parameter
    leaf at its TP-local size: a gradient reduce-scatter and a parameter
    all-gather where ``zero1_spec`` shards the leaf over DP (FSDP gathers
    the parameters twice, for forward and for backward), a gradient
    all-reduce where no dim divides."""
    dp = _dp_axes(cfg, grid)
    g = spec_lib.axis_size(grid, dp)
    if g <= 1:
        return []
    span = hlo.spans_nodes(line_ranks(grid, dp))
    fsdp = cfg.fsdp or cfg.parallelism == "fsdp"
    out = []
    for leaf, spec in zip(spec_lib.leaves(params), spec_lib.leaves(pspec)):
        tp_local = spec_lib.local_shape(leaf.shape, spec, grid)
        z = spec_lib.zero1_spec(spec, leaf, grid, axes=cfg.dp_axes)
        if z == tuple(spec) + (None,) * (leaf.dim() - len(spec)):
            out.append(record("all-reduce", tp_local, leaf.dtype, g,
                              spans_nodes=span, what="dp grad"))
            continue
        shard = spec_lib.local_shape(leaf.shape, z, grid)
        out.append(record("reduce-scatter", shard, leaf.dtype, g,
                          spans_nodes=span, what="dp grad"))
        for _ in range(2 if fsdp else 1):
            out.append(record("all-gather", tp_local, leaf.dtype, g,
                              spans_nodes=span, what="dp param"))
    return out


# row-parallel (activation-reducing) products per layer kind under TP
_TP_REDUCES = {"attn": 2, "attn_local": 2, "moe": 1, "rwkv": 2, "rec": 2,
               "cross": 3}


def rule_tp(cfg, grid, layer: str, B_loc: int, S: int,
            step: str) -> List[Dict]:
    """A TP-sharded layer's activation traffic on the 'model' line: one
    all-reduce of (B_loc, S, d) per row-parallel product (attention's wo,
    the MLP's w2, ...; arctic's dense residual adds one), or with
    ``sp_collectives`` the sequence-parallel reduce-scatter / all-gather
    pair of the same tensor; times the step's passes."""
    M = grid.axis_size("model") if "model" in grid.axes else 1
    if cfg.parallelism != "tp" or M <= 1:
        return []
    n = _TP_REDUCES[layer] + (layer == "moe" and cfg.moe_dense_residual)
    span = hlo.spans_nodes(line_ranks(grid, ("model",)))
    full = (B_loc, S, cfg.d_model)
    out = []
    for _ in range(n * _passes(cfg, step)):
        if cfg.sp_collectives and S % M == 0:
            out.append(record("reduce-scatter", (B_loc, S // M, cfg.d_model),
                              cfg.compute_dtype, M, spans_nodes=span,
                              what="sp"))
            out.append(record("all-gather", full, cfg.compute_dtype, M,
                              spans_nodes=span, what="sp"))
        else:
            out.append(record("all-reduce", full, cfg.compute_dtype, M,
                              spans_nodes=span, what="tp"))
    return out


def rule_ep(cfg, grid, layer: str, B_loc: int, S: int,
            step: str) -> List[Dict]:
    """An MoE layer with ``moe_impl="a2a"`` on a 'model' line of M > 1
    ranks with S divisible by M (else the port falls back to ``moe_ffn``):
    the hops ``moe_a2a`` issues, tokens and outputs as (M Csend, d) and
    the expert ids as (M Csend,) int64, the output all-gather of
    (B_loc, S, d), and the aux mean; times the step's passes."""
    M = grid.axis_size("model") if "model" in grid.axes else 1
    if layer != "moe" or cfg.moe_impl != "a2a" or M <= 1 or S % M:
        return []
    T = B_loc * S // M
    Csend, _ = moe_a2a.capacities(cfg, T, M)
    span = hlo.spans_nodes(line_ranks(grid, ("model",)))
    out = []
    for _ in range(_passes(cfg, step)):
        out += [record("all-reduce", (), torch.float32, M, spans_nodes=span,
                       what="ep aux"),
                record("all-to-all", (M * Csend, cfg.d_model),
                       cfg.compute_dtype, M, spans_nodes=span,
                       what="ep tokens"),
                record("all-to-all", (M * Csend,), torch.int64, M,
                       spans_nodes=span, what="ep ids"),
                record("all-to-all", (M * Csend, cfg.d_model),
                       cfg.compute_dtype, M, spans_nodes=span,
                       what="ep outputs"),
                record("all-gather", (B_loc, S, cfg.d_model),
                       cfg.compute_dtype, M, spans_nodes=span,
                       what="ep gather")]
    return out


def layout_collectives(cfg, grid, step: str, B: int, S: int, params=None,
                       pspec=None) -> List[Dict]:
    """Every rule over a step of global batch B and sequence S (S = 1 for
    a decode step)."""
    dp = spec_lib.axis_size(grid, _dp_axes(cfg, grid))
    B_loc = B // dp if B % dp == 0 else B
    ops = []
    kinds = list(layer_kinds(cfg))
    if cfg.encoder_layers:
        kinds += list(layer_kinds(cfg, "encoder"))
    for layer in kinds:
        ops += rule_tp(cfg, grid, layer, B_loc, S, step)
        ops += rule_ep(cfg, grid, layer, B_loc, S, step)
    if step == "train" and params is not None:
        ops += rule_dp(cfg, grid, params, pspec)
    return ops


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def build_cell(arch: str, shape: str, grid, *, microbatches: int = 1,
               cfg_override=None, batch=None, seq=None):
    """Returns (fn, args, info): the step, its meta-device arguments, and
    what the memory and collective models need (config, kind, specs)."""
    cfg = cfg_override if cfg_override is not None else configs_lib.get(arch)
    if SHAPES[shape]["kind"] != "train" and cfg.parallelism != "tp":
        # serving always uses TP: decode batches do not shard over 256+ ways
        cfg = dataclasses.replace(cfg, parallelism="tp")
    spec = input_specs(cfg, shape)
    if batch is not None or seq is not None:
        spec = _resized(cfg, spec, batch, seq)
    params = abstract_params(cfg)
    if spec["kind"] == "decode":
        # serving checkpoints are bf16 (deployment dtype; halves weight HBM)
        params = spec_lib.tree_map(
            lambda x: x.to(torch.bfloat16) if x.dtype == torch.float32
            else x, params)
    pspec = spec_lib.param_spec(params, cfg.parallelism)
    if (cfg.fsdp or cfg.parallelism == "fsdp") and spec["kind"] == "train":
        # ZeRO-3/FSDP: params also sharded over DP (all-gathered per layer)
        pspec = spec_lib.zero1_spec(pspec, params, grid, axes=cfg.dp_axes)
    info = {"cfg": cfg, "kind": spec["kind"], "params": params,
            "pspec": pspec, "tp_pspec": spec_lib.param_spec(
                params, cfg.parallelism)}

    if spec["kind"] == "train":
        opt = make_optimizer(cfg.optimizer)
        opt_state = opt.init(params)
        ospec = {k: spec_lib.zero1_spec(spec_lib.param_spec(
                     v, cfg.parallelism), v, grid, axes=cfg.dp_axes)
                 for k, v in opt_state.items()}
        bspec = spec_lib.batch_spec(spec["batch"], grid, axes=cfg.dp_axes)
        info.update(state=[(opt_state, ospec), (spec["batch"], bspec)],
                    B=_batch_of(spec["batch"]), S=_seq_of(spec["batch"]))
        fn = make_train_step(cfg, opt, microbatches=microbatches)
        return fn, (params, opt_state, spec["batch"], 0), info

    if spec["kind"] == "prefill":
        s_max = spec["s_max"]
        bspec = spec_lib.batch_spec(spec["batch"], grid)
        info.update(state=[(spec["batch"], bspec)],
                    B=_batch_of(spec["batch"]), S=_seq_of(spec["batch"]))

        def fn(params, batch):
            return prefill_fn(params, cfg, s_max=s_max, attn_impl="xla",
                              wkv_impl="xla", **batch)

        return fn, (params, spec["batch"]), info

    # decode
    caches = spec["caches"]
    cspec = spec_lib.cache_spec(caches, grid)
    tspec = spec_lib.divisible_spec((DP,), spec["tokens"].shape, grid)
    info.update(state=[(caches, cspec), ([spec["tokens"]], [tspec])],
                B=spec["tokens"].shape[0], S=1)
    fn = make_serve_step(cfg)
    pos = SHAPES[shape]["seq"] - 1
    return fn, (params, caches, spec["tokens"], pos), info


def _batch_of(batch) -> int:
    for key in ("tokens", "labels", "embeds"):
        if key in batch:
            return batch[key].shape[0]
    raise KeyError("batch has no batch dim")


def _seq_of(batch) -> int:
    for key in ("tokens", "labels", "embeds"):
        if key in batch:
            return batch[key].shape[1]
    raise KeyError("batch has no sequence")


def _resized(cfg, spec, batch, seq):
    """``spec`` at another global batch and / or sequence length (small
    cells for tests and smoke configs)."""
    if spec["kind"] == "decode":
        B = batch or spec["tokens"].shape[0]
        S = seq or spec["caches"][0][next(iter(spec["caches"][0]))].shape[2]
        s_enc = 4096 if cfg.family == "encdec" else 0
        return dict(spec, tokens=specs_mod.sds((B,), torch.int32),
                    caches=init_caches(cfg, B, S, s_enc=s_enc,
                                       dtype=torch.bfloat16,
                                       device=specs_mod.META))
    B = batch or _batch_of(spec["batch"])
    S = seq or _seq_of(spec["batch"])
    out = dict(spec, batch=specs_mod._train_or_prefill_inputs(
        cfg, B, S, with_labels=spec["kind"] == "train"))
    if spec["kind"] == "prefill":
        out["s_max"] = S
    return out


def count(fn, args) -> Dict[str, float]:
    """FLOPs and unfused bytes of one call on the meta device."""
    with hlo.OpCounter() as c:
        fn(*args)
    return {"flops": float(c.flops), "hbm_bytes": float(c.bytes)}


def memory_bytes(info, grid) -> int:
    """Per-device bytes of params, optimizer state, batch and caches."""
    total = spec_lib.local_bytes(info["params"], info["pspec"], grid)
    for tree, spec in info["state"]:
        total += spec_lib.local_bytes(tree, spec, grid)
    return total


def _unit(cfg) -> int:
    return len(cfg.pattern) if cfg.family == "griffin" and cfg.pattern \
        else 1


def _reduced(cfg, nl: int):
    kw = dict(num_layers=nl)
    if cfg.family == "encdec":
        kw["encoder_layers"] = nl
    return dataclasses.replace(cfg, **kw)


def cell_costs(arch, shape, grid, *, microbatches=1, cfg_override=None,
               batch=None, seq=None, skip_cost=False) -> Dict:
    """Counts, memory and modeled collectives of one cell."""
    fn, args, info = build_cell(arch, shape, grid,
                                microbatches=microbatches,
                                cfg_override=cfg_override, batch=batch,
                                seq=seq)
    cfg = info["cfg"]
    coll = hlo.stats(layout_collectives(cfg, grid, info["kind"], info["B"],
                                        info["S"], info["params"],
                                        info["tp_pspec"]))
    unit = _unit(cfg)
    two = _reduced(cfg, 2 * unit)
    p2 = abstract_params(two)
    coll2 = hlo.stats(layout_collectives(
        two, grid, info["kind"], info["B"], info["S"], p2,
        spec_lib.param_spec(p2, cfg.parallelism)))
    out = {"cfg": cfg, "info": info, "collectives": coll,
           "collective_by_kind_unit2": coll2.by_kind(),
           "memory_bytes": memory_bytes(info, grid)}
    if skip_cost:
        out.update(flops=0.0, hbm_bytes=0.0, per_unit={}, non_layer={})
        return out
    full = count(fn, args)
    n_units = cfg.num_layers // unit
    out.update(full)
    if n_units > 1 and cfg.num_layers % unit == 0:
        f1, a1, _ = build_cell(arch, shape, grid, microbatches=microbatches,
                               cfg_override=_reduced(cfg, unit),
                               batch=batch, seq=seq)
        one = count(f1, a1)
        per = {k: (full[k] - one[k]) / (n_units - 1) for k in full}
        out["per_unit"] = per
        out["non_layer"] = {k: one[k] - per[k] for k in full}
    else:
        out["per_unit"], out["non_layer"] = {}, {}
    return out


def run_cell(arch: str, shape: str, *, multi_pod: bool, out_dir: Path,
             microbatches: int = 1, tag: str = "",
             skip_full: bool = False, skip_cost: bool = False) -> dict:
    grid = make_production_mesh(multi_pod=multi_pod)
    n_chips = grid.size
    cfg = configs_lib.get(arch)
    costs = cell_costs(arch, shape, grid, microbatches=microbatches,
                       skip_cost=skip_cost)
    flops = costs["flops"] / n_chips
    hbm_bytes = costs["hbm_bytes"] / n_chips
    coll = costs["collectives"]
    terms = roofline_terms(flops, hbm_bytes, coll)
    model_flops = 6.0 * cfg.active_param_count() \
        * SHAPES[shape]["batch"] * SHAPES[shape]["seq"]
    if SHAPES[shape]["kind"] == "decode":
        model_flops = 6.0 * cfg.active_param_count() * SHAPES[shape]["batch"]
    if SHAPES[shape]["kind"] == "prefill":
        model_flops = 2.0 * cfg.active_param_count() \
            * SHAPES[shape]["batch"] * SHAPES[shape]["seq"]
    per = lambda d: {k: v / n_chips for k, v in d.items()}  # noqa: E731
    result = {
        "arch": arch, "shape": shape,
        "mesh": _mesh_name(grid),
        "chips": n_chips,
        "status": "ok",
        "per_device": {
            "flops": flops,
            "hbm_bytes": hbm_bytes,
            "collective_wire_bytes": coll.wire_bytes,
            "collective_operand_bytes": coll.operand_bytes,
            "collective_by_kind_unit2": costs["collective_by_kind_unit2"],
            "per_unit": per(costs["per_unit"]),
            "non_layer": per(costs["non_layer"]),
        },
        "roofline": terms,
        "model_flops_global": model_flops,
        "model_flops_per_device": model_flops / n_chips,
        "useful_flop_ratio": (model_flops / n_chips) / flops if flops else 0.0,
        "bytes_model": "unfused: each aten op's operands and results",
        "collective_model": COLLECTIVE_MODEL,
    }
    if not skip_full:
        result["per_device"].update({
            "peak_memory_bytes": costs["memory_bytes"],
            "argument_bytes": costs["memory_bytes"],
            "temp_bytes": None,
            "memory_model": MEMORY_MODEL,
        })
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{arch}__{shape}__{result['mesh']}{tag}.json"
    (out_dir / name).write_text(json.dumps(result, indent=2))
    return result


def fit_cell_costs(name, grid) -> Dict[str, Dict]:
    """Each program of a fit cell counted for one rank of ``grid``:
    FLOPs, unfused bytes, the collectives it issued, its inputs' bytes."""
    built = build_fit_cell(name, grid)
    out = {}
    with fake_group(grid.size):
        for phase, (fn, args) in built.items():
            with hlo.counting() as (ops, rec):
                fn(*args)
            out[phase] = {"flops": float(ops.flops),
                          "hbm_bytes": float(ops.bytes),
                          "collectives": rec.stats(),
                          "argument_bytes": sum(
                              a.numel() * a.element_size() for a in args)}
    return out


def run_fit_cell(name: str, *, multi_pod: bool, out_dir: Path, tag: str = "",
                 grid=None, quiet: bool = False):
    grid = grid if grid is not None else make_production_mesh(
        multi_pod=multi_pod)
    spec = CELLS[name] if isinstance(name, str) else name
    label = name if isinstance(name, str) else "custom"
    peak = hlo.PEAK_FP32 if spec["dtype"] == torch.float32 \
        else hlo.PEAK_FLOPS
    result = {"cell": f"admm_{label}", "m": spec["m"], "n": spec["n"],
              "dtype": str(spec["dtype"]).replace("torch.", ""),
              "mesh": _mesh_name(grid), "chips": grid.size, "status": "ok",
              "bytes_model": "unfused: each aten op's operands and results",
              "memory_model": "the program's inputs on one rank"}
    for phase, c in fit_cell_costs(spec, grid).items():
        terms = roofline_terms(c["flops"], c["hbm_bytes"], c["collectives"],
                               peak_flops=peak)
        result[phase] = {
            "flops": c["flops"], "hbm_bytes": c["hbm_bytes"],
            "collective_wire_bytes": c["collectives"].wire_bytes,
            "collective_by_kind": c["collectives"].by_kind(),
            "peak_memory_bytes": c["argument_bytes"],
            "roofline": terms,
        }
        t = terms
        if not quiet:
            print(f"[OK] admm_{label}:{phase} x {result['mesh']}: "
                  f"bottleneck={t['bottleneck']} "
                  f"compute={t['compute_s']*1e3:.2f}ms "
                  f"mem={t['memory_s']*1e3:.2f}ms "
                  f"coll={t['collective_s']*1e3:.3f}ms "
                  f"args={c['argument_bytes']/2**30:.2f}GiB", flush=True)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"admm_{label}__{result['mesh']}{tag}.json").write_text(
            json.dumps(result, indent=2))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--cost-only", action="store_true",
                    help="skip the per-device memory sum")
    ap.add_argument("--no-cost", action="store_true",
                    help="memory and collectives only (no count)")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--fit-cell", default="",
                    help="ADMM fit cell: star_f32|star_bf16|fig1_bf16")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (e.g. sp_collectives=False)")
    args = ap.parse_args(argv)
    get = configs_lib.get
    if args.set:
        def _patched(name):
            cfg = get(name)
            kv = {}
            for item in args.set:
                k, v = item.split("=", 1)
                cur = getattr(cfg, k)
                if isinstance(cur, bool):
                    v = v.lower() in ("1", "true", "yes")
                elif isinstance(cur, int):
                    v = int(v)
                elif isinstance(cur, float):
                    v = float(v)
                kv[k] = v
            return dataclasses.replace(cfg, **kv)

        configs_lib.get = _patched
    try:
        _run(args)
    finally:
        configs_lib.get = get


def _run(args):
    out_dir = Path(args.out)
    if args.fit_cell:
        run_fit_cell(args.fit_cell, multi_pod=args.multi_pod,
                     out_dir=out_dir, tag=args.tag)
        return

    cells = []
    if args.all:
        for arch in ARCHES:
            cfg = configs_lib.get(arch)
            for shape in SHAPES:
                if shape in cfg.skip_shapes:
                    continue
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            raise SystemExit("give --arch and --shape, --all, or --fit-cell")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            label = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
            t0 = time.time()
            try:
                r = run_cell(arch, shape, multi_pod=mp, out_dir=out_dir,
                             microbatches=args.microbatches, tag=args.tag,
                             skip_full=args.cost_only,
                             skip_cost=args.no_cost)
                t = r["roofline"]
                mem = r["per_device"].get("peak_memory_bytes") or 0
                print(f"[OK] {label}: count={time.time() - t0:.1f}s "
                      f"bottleneck={t['bottleneck']} "
                      f"compute={t['compute_s']:.4f}s "
                      f"mem={t['memory_s']:.4f}s "
                      f"coll={t['collective_s']:.4f}s "
                      f"state_mem={mem / 2**30:.2f}GiB "
                      f"useful={r['useful_flop_ratio']:.2f}",
                      flush=True)
            except Exception as e:
                # one failed cell is reported in its own file and the
                # sweep goes on; the exit status counts the failures
                failures += 1
                out_dir.mkdir(parents=True, exist_ok=True)
                name = (f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
                        f"{args.tag}.FAILED.json")
                (out_dir / name).write_text(json.dumps(
                    {"arch": arch, "shape": shape, "status": "failed",
                     "error": traceback.format_exc()}, indent=2))
                print(f"[FAIL] {label}: {e}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
