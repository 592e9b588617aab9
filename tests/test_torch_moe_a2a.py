"""Port parity for ``repro_torch.models.moe_a2a`` (all-to-all expert
parallelism over a grid of gloo ranks on the CPU) against the JAX package:
the mirror of ``tests/test_distributed.py::test_moe_a2a_matches_dense_
reference`` and the cases it leaves out.

The ranks of each world are spawned once for the module and run every
case (``moe_a2a.rank_cases``): a (4 data x 2 model) grid of 8 ranks, an
(8 x 1) grid on the same ranks, and a (1 x 2) grid of 2 ranks. One
subprocess with eight virtual XLA devices runs the JAX ``moe_ffn_a2a`` and
the JAX model on the same meshes.

Tolerances: 1e-4 against the dense reference at capacity 8 (the
reference test's bound); 1e-5 against the JAX a2a at capacity 1.25 (the
same sums in another order); 2e-5 on the olmoe smoke model's f32 hidden
states and last-token logits (summation order only, as
``tests/test_torch_models.py``'s f32 bound); the fallbacks bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax

jax.config.update("jax_platform_name", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import moe_a2a  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402
from repro_torch.sharding import compat  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 300
GRID = ((4, 2), ("data", "model"))
TDTYPE = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}

# tests/test_distributed.py:146-149
A2A_CFG = JConfig(name="t", family="moe", num_layers=1, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=100,
                  num_experts=8, experts_per_token=2, capacity_factor=8.0,
                  compute_dtype=jnp.float32, moe_impl="a2a")
TIGHT_CFG = dataclasses.replace(A2A_CFG, capacity_factor=1.25)
ARCTIC_CFG = dataclasses.replace(jconfigs.get_smoke("arctic-480b"),
                                 compute_dtype=jnp.float32)
OLMOE_CFG = dataclasses.replace(jconfigs.get_smoke("olmoe-1b-7b"),
                                compute_dtype=jnp.float32)
B, S, D = 8, 16, 64
OLMOE_B, OLMOE_S = 2, 16


def to_torch_config(jcfg):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["param_dtype"] = TDTYPE[jnp.dtype(jcfg.param_dtype)]
    kw["compute_dtype"] = TDTYPE[jnp.dtype(jcfg.compute_dtype)]
    return TConfig(**kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _x(seed, shape=(B, S, D)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _skewed(weights):
    """_x(1) pushed toward expert 0 (a router column): the routing
    crowds one expert, so capacity 1.25 drops pairs at both stages."""
    r = weights["a2a"]["router"][:, 0]
    return (_x(1) + 4.0 * r / np.linalg.norm(r)).astype(np.float32)


def _tokens():
    return np.random.default_rng(5).integers(
        0, OLMOE_CFG.vocab_size, (OLMOE_B, OLMOE_S)).astype(np.int32)


@pytest.fixture(scope="module")
def weights():
    return {
        "a2a": _np_tree(jmoe.init_moe(jax.random.PRNGKey(0), A2A_CFG)),
        "arctic": _np_tree(jmoe.init_moe(jax.random.PRNGKey(2),
                                         ARCTIC_CFG)),
        "olmoe": _np_tree(jax.jit(jm.init_params, static_argnums=0)(
            OLMOE_CFG, jax.random.PRNGKey(3))),
    }


def _ffn(cfg, params, x, grid=GRID, **kw):
    return dict(kind="ffn", cfg=to_torch_config(cfg), params=params, x=x,
                grid=grid, **kw)


@pytest.fixture(scope="module")
def ranks(weights):
    """name -> every rank's result, from one spawn per world."""
    cases8 = {
        "dense": _ffn(A2A_CFG, weights["a2a"], _x(1)),
        "tight": _ffn(TIGHT_CFG, weights["a2a"], _skewed(weights)),
        "arctic": _ffn(ARCTIC_CFG, weights["arctic"], _x(4)),
        "model_of_1": _ffn(TIGHT_CFG, weights["a2a"], _x(1),
                           grid=((8, 1), ("data", "model"))),
        "s_odd": _ffn(TIGHT_CFG, weights["a2a"], _x(1, (B, 15, D))),
    }
    tcfg = to_torch_config(OLMOE_CFG)
    cases2 = {
        "forward": dict(kind="forward", cfg=tcfg, params=weights["olmoe"],
                        tokens=_tokens(), grid=((1, 2), ("data", "model"))),
        "prefill": dict(kind="prefill", cfg=tcfg, params=weights["olmoe"],
                        tokens=_tokens(), s_max=OLMOE_S,
                        grid=((1, 2), ("data", "model"))),
    }
    out = {}
    for world, cases in ((8, cases8), (2, cases2)):
        res = compat.spawn(moe_a2a.rank_cases, world, "gloo",
                           args=(list(cases.values()), "cpu"),
                           device="cpu", threads=1, timeout=SPAWN_TIMEOUT)
        for i, name in enumerate(cases):
            out[name] = [r[i] for r in res]
    return out


JAX_SCRIPT = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
import repro.configs as C
from repro.models import moe as jmoe, model as jm
from repro.models.config import ModelConfig
from repro.models.decode import prefill
from repro.models.moe_a2a import moe_ffn_a2a
from repro.sharding import compat
inp = np.load(sys.argv[1])
cfg = ModelConfig(name="t", family="moe", num_layers=1, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=100,
                  num_experts=8, experts_per_token=2, capacity_factor=1.25,
                  compute_dtype=jnp.float32, moe_impl="a2a")
arctic = dataclasses.replace(C.get_smoke("arctic-480b"),
                             compute_dtype=jnp.float32)
olmoe = dataclasses.replace(C.get_smoke("olmoe-1b-7b"),
                            compute_dtype=jnp.float32)
out = {}
mesh = compat.make_mesh((4, 2), ("data", "model"))
with compat.use_mesh(mesh):
    for name, c, key, x in (("tight", cfg, 0, inp["x1"]),
                            ("arctic", arctic, 2, inp["x4"])):
        p = jmoe.init_moe(jax.random.PRNGKey(key), c)
        xg = jax.device_put(jnp.asarray(x),
                            NamedSharding(mesh, P("data", None, None)))
        o, aux = jax.jit(lambda p, x, c=c: moe_ffn_a2a(p, c, x))(p, xg)
        out[name] = np.asarray(o)
        out[name + "_aux"] = np.asarray(aux)
mesh = compat.make_mesh((1, 2), ("data", "model"))
params = jax.jit(jm.init_params, static_argnums=0)(olmoe,
                                                    jax.random.PRNGKey(3))
tokens = jnp.asarray(inp["tokens"])
with compat.use_mesh(mesh):
    h, aux = jax.jit(lambda p, t: jm.forward(p, olmoe, tokens=t))(params,
                                                                 tokens)
    logits, _ = jax.jit(lambda p, t: prefill(p, olmoe, tokens=t,
                                             s_max=t.shape[1]))(params,
                                                                tokens)
out["forward"] = np.asarray(h)
out["forward_aux"] = np.asarray(aux)
out["prefill"] = np.asarray(logits, np.float32)
np.savez(sys.argv[2], ndev=len(jax.devices()), **out)
"""


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory, weights):
    """The JAX a2a and model on real (4, 2) and (1, 2) meshes of eight
    virtual CPU devices, in a subprocess."""
    tmp = tmp_path_factory.mktemp("a2a")
    np.savez(tmp / "in.npz", x1=_skewed(weights), x4=_x(4),
             tokens=_tokens())
    p = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz")], cwd=ROOT, capture_output=True, text=True,
        timeout=600,
        env={"PYTHONPATH": "src", "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
             **{k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR")
                if k in os.environ}})
    assert p.returncode == 0, p.stderr[-3000:]
    out = dict(np.load(tmp / "out.npz"))
    assert int(out["ndev"]) == 8
    return out


def _global(res, grid=GRID):
    """The global (B, S, d) output from the ranks of the first 'model'
    column (every rank of a line holds the whole gathered line)."""
    M = grid[0][1]
    return np.concatenate([r["out"] for r in res[::M]])


def _touched(out, ref, tol=1e-4):
    """Tokens whose output lost at least one (token, expert) pair."""
    return int(np.sum(np.abs(out - ref).reshape(-1, out.shape[-1]).max(-1)
                      > tol))


def test_moe_a2a_matches_dense_reference(weights, ranks):
    """tests/test_distributed.py:133 on gloo ranks: capacity 8 on a
    (4 data x 2 model) grid equals the JAX no-capacity dense reference."""
    ref = np.asarray(jmoe.moe_ffn_dense_ref(
        jax.tree.map(jnp.asarray, weights["a2a"]), A2A_CFG,
        jnp.asarray(_x(1))))
    res = ranks["dense"]
    err = float(np.max(np.abs(_global(res) - ref)))
    assert err < 1e-4, err
    # every rank of a 'model' line holds the same gathered activations
    for r in range(0, 8, 2):
        np.testing.assert_array_equal(res[r]["out"], res[r + 1]["out"])
    assert sum(r["kept"] for r in res) == sum(r["routed"] for r in res)


def test_moe_a2a_drops_match_jax_a2a(weights, ranks, jax_mesh):
    """Capacity 1.25 drops pairs: the port's output equals the JAX
    ``moe_ffn_a2a`` on a (4, 2) mesh, the same tokens lose pairs, and the
    aux loss is the same mean."""
    res = ranks["tight"]
    got, want = _global(res), jax_mesh["tight"]
    err = float(np.max(np.abs(got - want)))
    assert err < 1e-5, err
    ref = np.asarray(jmoe.moe_ffn_dense_ref(
        jax.tree.map(jnp.asarray, weights["a2a"]), TIGHT_CFG,
        jnp.asarray(_skewed(weights))))
    touched = _touched(got, ref)
    assert touched == _touched(want, ref) and touched > 0
    dropped = sum(r["routed"] - r["kept"] for r in res)
    assert dropped >= touched
    for r in res:
        assert abs(r["aux"] - float(jax_mesh["tight_aux"])) < 1e-6


def test_moe_a2a_dense_residual_matches_jax(ranks, jax_mesh):
    """arctic's smoke config (8 experts top-2 and the dense residual MLP)
    at its own capacity 1.25."""
    err = float(np.max(np.abs(_global(ranks["arctic"])
                              - jax_mesh["arctic"])))
    assert err < 1e-5, err


def test_moe_a2a_falls_back_to_moe_ffn_bit_for_bit(weights, ranks):
    """No grid, a 'model' axis of 1, and S not divisible by M: each rank's
    result is ``moe_ffn`` on its rows, bit for bit."""
    cfg = to_torch_config(TIGHT_CFG)
    p = convert.lm_params(weights["a2a"], device="cpu")
    x = torch.from_numpy(_x(1))
    with torch.no_grad():
        got, aux = moe_a2a.moe_ffn_a2a(p, cfg, x)
        want, aux_w = tmoe.moe_ffn(p, cfg, x)
    assert torch.equal(got, want) and torch.equal(aux, aux_w)
    for name, xs, per in (("model_of_1", _x(1), 1),
                          ("s_odd", _x(1, (B, 15, D)), 2)):
        for r, res in enumerate(ranks[name]):
            i = r // (2 if name == "s_odd" else 1)
            with torch.no_grad():
                want, _ = tmoe.moe_ffn(
                    p, cfg, torch.from_numpy(xs[i * per:(i + 1) * per]))
            np.testing.assert_array_equal(res["out"], want.numpy())
            assert not any(o["kind"] == "all-to-all" for o in res["ops"])


def test_olmoe_forward_and_prefill_on_a_grid_match_jax_mesh(ranks,
                                                           jax_mesh):
    """The olmoe smoke config (moe_impl "a2a") in f32: ``forward``'s
    hidden states and aux, and prefill's last-token logits, on a (1 x 2)
    grid against the JAX model on a (1, 2) mesh."""
    for r in ranks["forward"]:
        err = float(np.max(np.abs(r["out"] - jax_mesh["forward"])))
        assert err < 2e-5, err
        assert abs(r["aux"] - float(jax_mesh["forward_aux"])) < 2e-5
        assert sum(o["kind"] == "all-to-all" for o in r["ops"]) \
            == 3 * OLMOE_CFG.num_layers
    for r in ranks["prefill"]:
        err = float(np.max(np.abs(r["out"] - jax_mesh["prefill"])))
        assert err < 2e-5, err


def test_recorder_sees_three_hops_of_formula_bytes(ranks):
    """Each layer issues three all-to-alls on its 'model' line: the tokens
    and the outputs, each Csend x M x d x 4 bytes (the formula's two hops),
    and the expert ids; then the line's all-gather of the output."""
    cfg = to_torch_config(TIGHT_CFG)
    T = B // 4 * S // 2
    Csend, _ = moe_a2a.capacities(cfg, T, 2)
    for r in ranks["tight"]:
        hops = [o for o in r["ops"] if o["kind"] == "all-to-all"]
        assert len(hops) == 3 and all(o["group"] == 2 for o in hops)
        token_hops = [o["bytes"] for o in hops if o["bytes"] != Csend * 2 * 8]
        assert sum(token_hops) == moe_a2a.hop_bytes(cfg, T, 2, 4)
        gathers = [o for o in r["ops"] if o["kind"] == "all-gather"]
        assert [o["bytes"] for o in gathers] == [B // 4 * S * D * 4]
