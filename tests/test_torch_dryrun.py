"""Port parity for ``repro_torch.launch.input_specs``, ``fit_cell`` and
``dryrun``: every (full config x shape) cell's meta-device parameters,
batches and caches against the JAX ``input_specs`` / ``abstract_params``
under ``eval_shape``; the mirror of ``tests/test_distributed.py::test_mini_
production_mesh_dryrun`` on a (4, 2) grid; a fit cell's counts against the
exact matmul count and the ring formula; each layout rule against its own
formula. Shapes, dtypes, FLOPs and bytes are exact: no tolerance."""
import json

import jax

jax.config.update("jax_platform_name", "cpu")

import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.tree_util import DictKey, SequenceKey  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.launch import input_specs as jinput  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import fit_cell  # noqa: E402
from repro_torch.launch import input_specs as tinput  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import moe_a2a  # noqa: E402
from repro_torch.roofline import hlo  # noqa: E402
from repro_torch.sharding import specs as tspecs  # noqa: E402

ARCHS = sorted(tconfigs.ALIASES)
GRID = make_mesh((4, 2), ("data", "model"))
DTYPES = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.int32): torch.int32}


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(p.key if isinstance(p, DictKey) else p.idx for p in path
                  if isinstance(p, (DictKey, SequenceKey))):
            (tuple(x.shape), DTYPES[jnp.dtype(x.dtype)]) for path, x in flat}


def _torch_leaves(tree):
    out = {}

    def put(path, t):
        assert t.device.type == "meta", path
        out[path] = (tuple(t.shape), t.dtype)
    tspecs.tree_map_with_path(put, tree)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_abstract_params_match(arch):
    """Every shape of the full config: the kind, each input's shape and
    dtype, and every parameter leaf (the keys ``convert.lm_params``
    carries), all on the meta device."""
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    assert _torch_leaves(tinput.abstract_params(tcfg)) \
        == _jax_leaves(jinput.abstract_params(jcfg))
    for shape in jinput.SHAPES:
        if shape in jcfg.skip_shapes:
            with pytest.raises(ValueError):
                tinput.input_specs(tcfg, shape)
            continue
        j, t = jinput.input_specs(jcfg, shape), tinput.input_specs(tcfg,
                                                                   shape)
        assert j.keys() == t.keys() and j["kind"] == t["kind"]
        for key in j:
            if key == "kind":
                continue
            if key == "s_max":
                assert j[key] == t[key]
                continue
            tree = t[key] if isinstance(t[key], (dict, list)) else [t[key]]
            jtree = j[key] if isinstance(j[key], (dict, list)) \
                else [j[key]]
            assert _torch_leaves(tree) == _jax_leaves(jtree), (shape, key)
    assert tinput.SHAPES == jinput.SHAPES


@pytest.mark.parametrize("arch", ARCHS)
def test_mini_production_mesh_dryrun(arch):
    """tests/test_distributed.py:160 on the port: each smoke config's
    train step (AdamW, batch 8 x 64) counted on a (4, 2) grid, with FLOPs
    and modeled collectives."""
    cfg = tconfigs.get_smoke(arch)
    c = dryrun.cell_costs(arch, "train_4k", GRID, cfg_override=cfg,
                          batch=8, seq=64)
    assert c["flops"] > 0, arch
    assert len(c["collectives"].ops) > 0, arch
    assert c["hbm_bytes"] > 0 and c["memory_bytes"] > 0


def test_fit_cell_counts_equal_the_exact_matmul_count():
    """A fit cell at reduced m on a (4, 2) grid: setup counts the Gram's
    2 m_loc n^2, an iteration (either form) its two products 4 m_loc n;
    the all-reduces are recorded as issued, at the ring formula's bytes."""
    m, n = 8 * 4096, 24
    m_loc = m // GRID.size
    spec = dict(m=m, n=n, dtype=torch.float32)
    costs = dryrun.fit_cell_costs(spec, GRID)
    assert costs["setup"]["flops"] == 2 * m_loc * n * n
    assert costs["iter"]["flops"] == costs["fused_iter"]["flops"] \
        == 4 * m_loc * n
    ar = costs["setup"]["collectives"].ops
    assert [(o["kind"], o["bytes"], o["group"]) for o in ar] == [
        ("all-reduce", n * n * 4, 8)]
    assert ar[0]["wire_bytes"] == int(2 * n * n * 4 * 7 / 8)
    it = costs["fused_iter"]["collectives"].ops
    assert [(o["kind"], o["bytes"]) for o in it] == [("all-reduce", n * 4),
                                                      ("all-reduce", 4)]
    assert costs["setup"]["argument_bytes"] == m_loc * n * 4


def test_fit_cell_json_and_cli(tmp_path, capsys):
    """``--fit-cell star_f32`` on the 16 x 16 grid: the reference's
    fields (compile_s aside), one all-reduce of the 307 x 307 Gram."""
    dryrun.main(["--fit-cell", "star_f32", "--out", str(tmp_path)])
    r = json.loads((tmp_path / "admm_star_f32__16x16.json").read_text())
    assert r["chips"] == 256 and r["m"] == 950_272_000
    m_loc = r["m"] // 256
    assert r["setup"]["flops"] == 2 * m_loc * 307 * 307
    assert r["setup"]["collective_by_kind"] == {
        "all-reduce": int(2 * 307 * 307 * 4 * 255 / 256)}
    for phase in ("setup", "iter", "fused_iter"):
        assert set(r[phase]) == {"flops", "hbm_bytes",
                                 "collective_wire_bytes",
                                 "collective_by_kind", "peak_memory_bytes",
                                 "roofline"}
    assert "[OK] admm_star_f32:fused_iter" in capsys.readouterr().out


def test_run_cell_json_fields(tmp_path):
    """One full cell: the reference's JSON fields less lower_s and
    compile_s, plus what says which numbers are models."""
    r = dryrun.run_cell("olmoe-1b-7b", "decode_32k", multi_pod=False,
                        out_dir=tmp_path)
    saved = json.loads(
        (tmp_path / "olmoe-1b-7b__decode_32k__16x16.json").read_text())
    assert saved == json.loads(json.dumps(r))
    assert {"arch", "shape", "mesh", "chips", "status", "per_device",
            "roofline", "model_flops_global", "model_flops_per_device",
            "useful_flop_ratio"} <= set(r)
    assert "lower_s" not in r and "compile_s" not in r
    pd = r["per_device"]
    for key in ("flops", "hbm_bytes", "collective_wire_bytes",
                "collective_operand_bytes", "collective_by_kind_unit2",
                "per_unit", "non_layer", "peak_memory_bytes",
                "argument_bytes", "memory_model"):
        assert key in pd, key
    assert r["chips"] == 256 and pd["flops"] > 0
    assert "not a measurement" in r["collective_model"]
    # 16 decode layers: per_unit x 16 + non_layer is the whole count
    total = pd["per_unit"]["flops"] * 16 + pd["non_layer"]["flops"]
    assert abs(total - pd["flops"]) <= 1e-6 * pd["flops"]


def test_rule_ep_is_the_a2a_formula():
    """rule_ep: the two token hops are 2 x Csend x M x d x dtype
    (``moe_a2a.hop_bytes``), plus the ids hop and the line's gather;
    three times in a train step with remat."""
    cfg = tconfigs.get_smoke("olmoe-1b-7b")
    B_loc, S = 2, 64
    ops = dryrun.rule_ep(cfg, GRID, "moe", B_loc, S, "prefill")
    tok = [o for o in ops if o["what"] in ("ep tokens", "ep outputs")]
    T = B_loc * S // 2
    assert sum(o["bytes"] for o in tok) == moe_a2a.hop_bytes(
        cfg, T, 2, torch.empty((), dtype=cfg.compute_dtype).element_size())
    assert [o["kind"] for o in ops].count("all-to-all") == 3
    assert len(dryrun.rule_ep(cfg, GRID, "moe", B_loc, S, "train")) \
        == 3 * len(ops)
    assert dryrun.rule_ep(cfg, GRID, "moe", B_loc, 63, "prefill") == []
    assert dryrun.rule_ep(cfg, GRID, "attn", B_loc, S, "prefill") == []


def test_rule_tp_counts_row_parallel_products():
    import dataclasses
    cfg = dataclasses.replace(tconfigs.get_smoke("qwen3-8b"),
                              parallelism="tp")
    ops = dryrun.rule_tp(cfg, GRID, "attn", 2, 64, "prefill")
    # attention's wo and the MLP's w2, each a sequence-parallel pair
    assert [o["kind"] for o in ops] == ["reduce-scatter", "all-gather"] * 2
    assert ops[1]["bytes"] == 2 * 64 * cfg.d_model * \
        torch.empty((), dtype=cfg.compute_dtype).element_size()
    plain = dataclasses.replace(cfg, sp_collectives=False)
    assert [o["kind"] for o in dryrun.rule_tp(plain, GRID, "attn", 2, 64,
                                              "train")] == ["all-reduce"] * 6
    fsdp = dataclasses.replace(cfg, parallelism="fsdp")
    assert dryrun.rule_tp(fsdp, GRID, "attn", 2, 64, "train") == []


def test_rule_dp_zero1_and_fsdp():
    """ZeRO-1: a reduce-scatter of the gradient's DP shard and an
    all-gather of the TP-local parameter per leaf that divides, an
    all-reduce where none does; FSDP gathers twice."""
    import dataclasses
    cfg = dataclasses.replace(tconfigs.get_smoke("qwen3-8b"),
                              parallelism="tp", fsdp=False)
    params = {"blocks": [{"mlp": {"w1": torch.empty((3, 8, 6),
                                                    device="meta")}}],
              "final_norm": torch.empty((7,), device="meta")}
    pspec = tspecs.param_spec(params, "tp")
    ops = dryrun.rule_dp(cfg, GRID, params, pspec)
    assert [(o["kind"], o["bytes"], o["group"]) for o in ops] == [
        ("reduce-scatter", 3 * 2 * 3 * 4, 4), ("all-gather", 3 * 8 * 3 * 4, 4),
        ("all-reduce", 7 * 4, 4)]
    fsdp = dataclasses.replace(cfg, fsdp=True)
    assert [o["kind"] for o in dryrun.rule_dp(fsdp, GRID, params, pspec)] \
        == ["reduce-scatter", "all-gather", "all-gather", "all-reduce"]


def test_fake_group_leaves_nothing_initialized():
    import torch.distributed as dist
    with fit_cell.fake_group(4):
        assert dist.get_world_size() == 4
    assert not dist.is_initialized()
    assert hlo.PEAK_FLOPS == 989.4e12
