"""Port parity: the prox kinds of ``repro_torch`` (K1's plain version and the
``core.prox`` losses) against the JAX package on the same numpy inputs.

The JAX side runs the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` does; tolerances are that file's (atol 2e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prox as jprox
from repro.kernels.prox.ops import prox_update as j_prox_update
from repro_torch.core import prox as tprox
from repro_torch.kernels.prox import ops as prox_ops

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

KINDS = [("logistic", 10.0, 0.0), ("hinge", 0.7, 0.0), ("l1", 0.3, 0.0),
         ("least_squares", 2.0, 0.0), ("quantile", 1.5, 0.3)]


def _inputs(m, seed=0):
    rng = np.random.default_rng(seed)
    dx = (3 * rng.standard_normal(m)).astype(np.float32)
    lam = rng.standard_normal(m).astype(np.float32)
    aux = np.sign(rng.standard_normal(m)).astype(np.float32)
    return dx, lam, aux


@pytest.mark.parametrize("m", [1000, 4093])
@pytest.mark.parametrize("kind,delta,param", KINDS)
def test_prox_plain_matches_jax_kernel(m, kind, delta, param):
    dx, lam, aux = _inputs(m)
    a = None if kind == "l1" else aux
    yj, lj = j_prox_update(jnp.asarray(dx), jnp.asarray(lam),
                           None if a is None else jnp.asarray(a), kind=kind,
                           delta=delta, interpret=True, block_rows=8,
                           param=param)
    yt, lt = prox_ops.prox_update(
        torch.from_numpy(dx), torch.from_numpy(lam),
        None if a is None else torch.from_numpy(a), kind=kind, delta=delta,
        param=param)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-6)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-6)


def _loss_pair(kind):
    if kind == "logistic":
        return jprox.make_logistic(), tprox.make_logistic()
    if kind == "hinge":
        return jprox.make_hinge(0.8), tprox.make_hinge(0.8)
    if kind == "l1":
        return jprox.make_l1(0.4), tprox.make_l1(0.4)
    if kind == "least_squares":
        return jprox.make_least_squares(), tprox.make_least_squares()
    return jprox.make_quantile(0.3), tprox.make_quantile(0.3)


@pytest.mark.parametrize("kind,delta,param", KINDS)
def test_core_losses_match_jax(kind, delta, param):
    z, _, aux = _inputs(2048, seed=1)
    jl, tl = _loss_pair(kind)
    zj, aj = jnp.asarray(z), jnp.asarray(aux)
    zt, at = torch.from_numpy(z), torch.from_numpy(aux)
    np.testing.assert_allclose(tl.prox(zt, delta, at).numpy(),
                               np.asarray(jl.prox(zj, delta, aj)), atol=2e-6)
    np.testing.assert_allclose(float(tl.value(zt, at)),
                               float(jl.value(zj, aj)), rtol=1e-5)
    if jl.grad is not None:
        np.testing.assert_allclose(tl.grad(zt, at).numpy(),
                                   np.asarray(jl.grad(zj, aj)), atol=1e-6)
    for field in ("name", "coordinatewise", "kernel_delta_scale",
                  "kernel_param", "ycols", "lipschitz"):
        assert getattr(tl, field) == getattr(jl, field), field


def test_logistic_value_matches_softplus_far_out():
    """value = sum softplus(-l z) exactly as jax.nn.softplus, including the
    tails where a thresholded softplus would switch to the identity."""
    z = np.array([-80.0, -25.0, -3.0, 0.0, 3.0, 25.0, 80.0], np.float32)
    lab = np.ones_like(z)
    jl, tl = jprox.make_logistic(), tprox.make_logistic()
    np.testing.assert_allclose(
        float(tl.value(torch.from_numpy(z), torch.from_numpy(lab))),
        float(jl.value(jnp.asarray(z), jnp.asarray(lab))), rtol=1e-6)


@pytest.mark.parametrize("spec", [{"name": "logistic"},
                                  {"name": "hinge", "C": 2.0},
                                  {"name": "l1", "mu": 0.5},
                                  {"name": "least_squares"},
                                  {"name": "quantile", "q": 0.25}])
def test_loss_from_spec_matches_jax(spec):
    jl, tl = jprox.loss_from_spec(spec), tprox.loss_from_spec(spec)
    assert tl.spec == jl.spec
    assert (tl.name, tl.kernel_delta_scale, tl.kernel_param) == \
        (jl.name, jl.kernel_delta_scale, jl.kernel_param)
    z, _, aux = _inputs(512, seed=2)
    np.testing.assert_allclose(
        tl.prox(torch.from_numpy(z), 1.3, torch.from_numpy(aux)).numpy(),
        np.asarray(jl.prox(jnp.asarray(z), 1.3, jnp.asarray(aux))),
        atol=2e-6)


def test_loss_from_spec_names_roadmap_for_unported():
    with pytest.raises(NotImplementedError, match="ROADMAP item 4"):
        tprox.loss_from_spec({"name": "huber"})


def test_prox_fusion_identity():
    """lam' + y == Dx + lam (conservation of the ADMM update)."""
    dx, lam, aux = _inputs(4096, seed=3)
    y, lam_new = prox_ops.prox_update(
        torch.from_numpy(dx), torch.from_numpy(lam), torch.from_numpy(aux),
        kind="logistic", delta=1.0)
    np.testing.assert_allclose((y + lam_new).numpy(), dx + lam, atol=2e-6)
