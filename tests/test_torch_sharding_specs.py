"""Port parity for ``repro_torch.sharding`` (``specs``, ``util``, the grid
of ``compat``) and ``repro_torch.launch.mesh`` against the JAX package.

Every leaf's spec of every smoke config under both parallelisms, the
ZeRO-1 trees, and the batch and cache specs on a (4, 2) grid equal the
JAX package's (its ``PartitionSpec`` read as a tuple; its mesh an
``AbstractMesh`` of the same shape). Specs are exact: no tolerance.
"""
import dataclasses

import jax

jax.config.update("jax_platform_name", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402
from jax.tree_util import DictKey, SequenceKey  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.launch import input_specs as jinput  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro.sharding import util as jutil  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import input_specs as tinput  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.sharding import compat  # noqa: E402
from repro_torch.sharding import specs as tspecs  # noqa: E402
from repro_torch.sharding import util as tutil  # noqa: E402

ARCHS = sorted(tconfigs.ALIASES)
JMESH = AbstractMesh((4, 2), ("data", "model"))
TGRID = tmesh.make_mesh((4, 2), ("data", "model"))


def _jax_paths(tree):
    """{path: leaf} of a JAX spec or shape tree; PartitionSpecs as
    tuples."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    out = {}
    for path, leaf in flat:
        key = tuple(p.key if isinstance(p, DictKey) else p.idx
                    for p in path if isinstance(p, (DictKey, SequenceKey)))
        out[key] = tuple(leaf) if isinstance(leaf, P) else leaf
    return out


def _torch_paths(tree):
    out = {}
    tspecs.tree_map_with_path(lambda path, leaf: out.__setitem__(path, leaf),
                              tree)
    return out


def _specs_equal(jtree, ttree):
    j, t = _jax_paths(jtree), _torch_paths(ttree)
    assert j.keys() == t.keys()
    for k in j:
        assert j[k] == t[k], (k, j[k], t[k])


def _smoke(arch):
    return jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_specs_match(arch):
    """param_spec under tp and fsdp, and zero1_spec on (4, 2) over the
    config's DP axes, leaf for leaf."""
    jcfg, tcfg = _smoke(arch)
    jp = jinput.abstract_params(jcfg)
    tp = tinput.abstract_params(tcfg)
    for par in ("tp", "fsdp"):
        js, ts = jspecs.param_spec(jp, par), tspecs.param_spec(tp, par)
        _specs_equal(js, ts)
        axes = dataclasses.replace(jcfg, parallelism=par).dp_axes
        _specs_equal(jspecs.zero1_spec(js, jp, JMESH, axes=axes),
                     tspecs.zero1_spec(ts, tp, TGRID, axes=axes))


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match(arch):
    """batch_spec of the train and prefill batches (default and fsdp DP
    axes) and cache_spec of the decode caches, with and without a grid."""
    jcfg, tcfg = _smoke(arch)
    for kind in ("train", "prefill"):
        jb = jinput._train_or_prefill_inputs(jcfg, 8, 64,
                                             with_labels=kind == "train")
        tb = tinput._train_or_prefill_inputs(tcfg, 8, 64,
                                             with_labels=kind == "train")
        for axes in (jutil.DP, ("pod", "data", "model")):
            assert {k: tuple(v) for k, v in jspecs.batch_spec(
                jb, JMESH, axes=axes).items()} \
                == tspecs.batch_spec(tb, TGRID, axes=axes)
    jc = jax.eval_shape(lambda: jinput.init_caches(jcfg, 8, 64,
                                                   dtype=jnp.bfloat16))
    tc = tinput.init_caches(tcfg, 8, 64, device="meta")
    _specs_equal(jspecs.cache_spec(jc, JMESH), tspecs.cache_spec(tc, TGRID))
    _specs_equal(jspecs.cache_spec(jc), tspecs.cache_spec(tc))


def test_divisible_spec_and_axis_size_match():
    for spec, shape in (((("pod", "data"), None), (8, 3)),
                        (("data", "model"), (6, 4)),
                        ((None, "model", "data"), (1, 3, 12)),
                        (("model",), (1,))):
        assert tuple(jspecs.divisible_spec(P(*spec), shape, JMESH)) \
            == tspecs.divisible_spec(spec, shape, TGRID)
    for entry in (None, "data", "model", ("pod", "data"),
                  ("data", "model"), "pod"):
        assert jspecs.axis_size(JMESH, entry) \
            == tspecs.axis_size(TGRID, entry)


def test_filter_spec_matches():
    for spec in ((("pod", "data"), None, "model"), ("pod",), (),
                 (("pod",), ("data", "model"), None)):
        for names in (("data", "model"), ("pod", "data", "model"),
                      ("model",)):
            assert tuple(jutil.filter_spec(P(*spec), names)) \
                == tutil.filter_spec(spec, names)
    assert (tutil.DP, tutil.MODEL) == (jutil.DP, jutil.MODEL)


def test_production_mesh_is_a_description():
    """make_production_mesh joins nothing: the reference's shapes and
    axes, no rank, no groups; per-axis sizes as the mesh's."""
    for multi in (False, True):
        g = tmesh.make_production_mesh(multi_pod=multi)
        assert not g.joined and not torch.distributed.is_initialized()
        want = ((2, 16, 16), ("pod", "data", "model")) if multi \
            else ((16, 16), ("data", "model"))
        assert (g.shape, g.axes) == want and g.size == np.prod(want[0])
        assert g.axis_size("model") == 16
        assert g.axis_size(("data", "model")) == 256
    assert compat.axis_size("model") == 1          # no grid: a world of 1


def test_grid_coordinates_and_lines_are_row_major():
    g = tmesh.make_mesh((2, 3, 4), ("pod", "data", "model"))
    assert g.coords_of(0) == (0, 0, 0) and g.coords_of(23) == (1, 2, 3)
    assert g.coords_of(13) == (1, 0, 1)
    assert g.line("model", 13) == [12, 13, 14, 15]
    assert g.line("data", 13) == [13, 17, 21]
    assert g.line("pod", 5) == [5, 17]
    assert g.index(("pod", "data"), (1, 2, 0)) == 5


def test_local_slice_cuts_under_a_spec():
    """A rank's block: a dim split over two axes is tiled row-major, an
    axis the grid lacks is ignored; ``local_bytes`` sums the blocks."""
    a = np.arange(8 * 6 * 4).reshape(8, 6, 4)
    spec = (("data", "model"), None, "pod")
    blocks = [tspecs.local_slice(a, spec, TGRID, TGRID.coords_of(r))
              for r in range(8)]
    assert all(b.shape == (1, 6, 4) for b in blocks)
    np.testing.assert_array_equal(np.concatenate(blocks), a)
    w = torch.zeros((4, 6), dtype=torch.bfloat16)
    assert tspecs.local_shape(w.shape, ("data", "model"), TGRID) == (1, 3)
    assert tspecs.local_bytes({"w": [w]}, {"w": [("data", "model")]},
                              TGRID) == 1 * 3 * 2


def test_lm_params_shard_is_the_ranks_expert_block():
    """convert.lm_params_shard: one rank's block of a JAX parameter tree
    (numpy) under param_spec, here the a2a path's expert shard."""
    jcfg, tcfg = _smoke("olmoe-1b-7b")
    from repro.models import model as jm
    jp = jax.tree.map(np.asarray, jax.jit(jm.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0)))
    spec = tspecs.param_spec(jp, "tp")
    full = convert.lm_params(jp, device="cpu")
    for r in range(8):
        c = TGRID.coords_of(r)
        mine = convert.lm_params_shard(jp, spec, TGRID, c, device="cpu")
        we1 = full["blocks"][0]["moe"]["we1"]     # (L, E, d, f): E on model
        E_loc = we1.shape[1] // 2
        assert torch.equal(mine["blocks"][0]["moe"]["we1"],
                           we1[:, c[1] * E_loc:(c[1] + 1) * E_loc])
        assert torch.equal(mine["blocks"][0]["moe"]["router"],
                           full["blocks"][0]["moe"]["router"])
