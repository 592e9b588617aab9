"""Port parity: the prox kinds of ``repro_torch`` (K1's plain version and the
``core.prox`` losses) against the JAX package on the same numpy inputs.

The JAX side runs the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` does; tolerances are that file's (atol 2e-6).
The kernels' shorter logistic chain (``csrc/prox.cuh``) is held through its
float32 mirror, ``logistic_prox_bracketed``, on a hard grid: against the
JAX kernel and the plain version at 4e-6 of max(1, max |y|), and element
by element against the float64 root within the float32 rounding band.
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import prox as tprox
from repro_torch.kernels.prox import ops as prox_ops
from repro_torch.kernels.prox.ref import (logistic_bracket,
                                          logistic_prox_bracketed,
                                          logistic_root_band)

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX side, imported by the parity tests only: the card's machine,
    which runs the ``cuda``-marked test, has no JAX."""
    import jax
    import jax.numpy as jnp
    from repro.core import prox as jprox
    from repro.kernels.prox.ops import prox_update
    jax.config.update("jax_platform_name", "cpu")
    return SimpleNamespace(jnp=jnp, prox=jprox, prox_update=prox_update)


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
    J = _jax()
    jnp = J.jnp
    dx, lam, aux = _inputs(m)
    a = None if kind == "l1" else aux
    yj, lj = J.prox_update(jnp.asarray(dx), jnp.asarray(lam),
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
    jprox = _jax().prox
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
    jnp = _jax().jnp
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
    J = _jax()
    jprox, jnp = J.prox, J.jnp
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
    J = _jax()
    jprox, jnp = J.prox, J.jnp
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
    """Every loss of the reference's table is ported now (huber and
    multinomial were the last): each spec builds, and a name the
    reference does not know raises as there."""
    assert sorted(tprox.LOSSES) == sorted(_jax().prox.LOSSES)
    for spec in ({"name": "huber"}, {"name": "multinomial", "classes": 3}):
        assert tprox.loss_from_spec(spec).spec == spec
    with pytest.raises(ValueError, match="unknown loss spec"):
        tprox.loss_from_spec({"name": "poisson"})


# every name of the reference's LOSSES table with its parameters
SPECS = {"logistic": {}, "hinge": {"C": 2.0}, "huber": {"delta": 0.7},
         "l1": {"mu": 0.5}, "least_squares": {},
         "linf_ball": {"radius": 0.8}, "shifted_least_squares": {},
         "quantile": {"q": 0.25}, "multinomial": {"classes": 4}}


def _spec_inputs(name, seed=5):
    rng = np.random.default_rng(seed)
    if name == "multinomial":
        z = (2 * rng.standard_normal((300, 4))).astype(np.float32)
        aux = rng.integers(0, 4, 300).astype(np.float32)
    else:
        z = (2 * rng.standard_normal(600)).astype(np.float32)
        aux = np.sign(rng.standard_normal(600)).astype(np.float32) \
            if name in ("logistic", "hinge") else \
            rng.standard_normal(600).astype(np.float32)
    return z, aux


@pytest.mark.parametrize("name", sorted(SPECS))
def test_every_loss_matches_jax(name):
    """prox (two deltas), value and grad of each loss at 1e-5, built from
    the factory table; the losses with a spec round-trip through
    ``loss_from_spec``."""
    J = _jax()
    jnp = J.jnp
    params = SPECS[name]
    jl = J.prox.LOSSES[name](*params.values())
    tl = tprox.LOSSES[name](*params.values())
    z, aux = _spec_inputs(name)
    zj, aj = jnp.asarray(z), jnp.asarray(aux)
    zt, at = torch.from_numpy(z), torch.from_numpy(aux)
    for delta in (0.3, 4.0):
        want = np.asarray(jl.prox(zj, delta, aj))
        np.testing.assert_allclose(tl.prox(zt, delta, at).numpy(), want,
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tl.value(zt, at)),
                               float(jl.value(zj, aj)), rtol=1e-5, atol=1e-5)
    assert (tl.grad is None) == (jl.grad is None)
    if jl.grad is not None:
        np.testing.assert_allclose(tl.grad(zt, at).numpy(),
                                   np.asarray(jl.grad(zj, aj)), atol=1e-5)
    for field in ("name", "coordinatewise", "kernel_delta_scale",
                  "kernel_param", "ycols", "lipschitz"):
        assert getattr(tl, field) == getattr(jl, field), field
    if name not in ("linf_ball", "shifted_least_squares"):
        spec = {"name": name, **params}
        jr, tr = J.prox.loss_from_spec(spec), tprox.loss_from_spec(spec)
        assert tr.spec == jr.spec == spec
        np.testing.assert_allclose(tr.prox(zt, 1.3, at).numpy(),
                                   np.asarray(jr.prox(zj, 1.3, aj)),
                                   rtol=1e-5, atol=1e-5)


def test_multinomial_prox_is_stationary():
    """The multinomial prox's root: softmax(y) - onehot + (y - z)/delta
    vanishes, per row."""
    z, aux = _spec_inputs("multinomial")
    zt, at = torch.from_numpy(z).double(), torch.from_numpy(aux)
    y = tprox.multinomial_prox_newton(zt, 2.0, at)
    onehot = torch.nn.functional.one_hot(at.long(), 4).double()
    g = torch.softmax(y, -1) - onehot + (y - zt) / 2.0
    assert float(g.abs().max()) < 1e-10


@pytest.mark.parametrize("groups,G", [(np.arange(24) // 4, 6),
                                      (np.array([0, 2, 1] * 8), 3)])
def test_group_soft_threshold_matches_jax(groups, G):
    jnp = _jax().jnp
    rng = np.random.default_rng(7)
    z = rng.standard_normal(24).astype(np.float32)
    z[groups == 1] *= 0.05                  # one group below the threshold
    for thresh in (0.3, 1.2):
        want = np.asarray(_jax().prox.group_soft_threshold(
            jnp.asarray(z), thresh, jnp.asarray(groups), G))
        got = tprox.group_soft_threshold(torch.from_numpy(z), thresh,
                                         torch.from_numpy(groups), G)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        assert bool((got[torch.from_numpy(groups == 1)] == 0).all())


def test_group_lasso_regularizer_matches_jax():
    J = _jax()
    from repro.exec import make_group_lasso_reg as j_reg
    from repro_torch.exec import make_group_lasso_reg as t_reg
    groups = np.arange(20) // 4
    jr, tr = j_reg(0.4, groups, 5), t_reg(0.4, groups, 5)
    x = np.random.default_rng(8).standard_normal(20).astype(np.float32)
    np.testing.assert_allclose(float(tr.value(torch.from_numpy(x))),
                               float(jr.value(J.jnp.asarray(x))), rtol=1e-5)
    np.testing.assert_allclose(
        tr.prox(torch.from_numpy(x), torch.tensor(0.7)).numpy(),
        np.asarray(jr.prox(J.jnp.asarray(x), 0.7)), rtol=1e-5, atol=1e-6)
    assert (tr.name, tr.inner_iters) == (jr.name, jr.inner_iters)


def test_stacked_prox_and_projections_match_jax():
    J = _jax()
    jnp, jprox = J.jnp, J.prox
    rng = np.random.default_rng(9)
    z = (3 * rng.standard_normal(50)).astype(np.float32)
    aux = np.concatenate([np.zeros(10), np.sign(rng.standard_normal(40))]
                         ).astype(np.float32)
    js = jprox.StackedProx((jprox.make_l1(0.5), jprox.make_logistic()),
                           (10, 40))
    ts = tprox.StackedProx((tprox.make_l1(0.5), tprox.make_logistic()),
                           (10, 40))
    zj, aj, zt, at = jnp.asarray(z), jnp.asarray(aux), \
        torch.from_numpy(z), torch.from_numpy(aux)
    np.testing.assert_allclose(ts.prox(zt, 2.0, at).numpy(),
                               np.asarray(js.prox(zj, 2.0, aj)), atol=1e-5)
    np.testing.assert_allclose(float(ts.value(zt, at)),
                               float(js.value(zj, aj)), rtol=1e-5)
    tl, jl = ts.as_loss("sparse_logistic"), js.as_loss("sparse_logistic")
    assert (tl.name, tl.coordinatewise, tl.grad) == \
        (jl.name, jl.coordinatewise, None)
    np.testing.assert_array_equal(
        tprox.project_nonneg(zt).numpy(),
        np.asarray(jprox.project_nonneg(zj)))
    np.testing.assert_array_equal(
        tprox.project_linf(zt, 1.5).numpy(),
        np.asarray(jprox.project_linf(zj, 1.5)))


def test_prox_fusion_identity():
    """lam' + y == Dx + lam (conservation of the ADMM update)."""
    dx, lam, aux = _inputs(4096, seed=3)
    y, lam_new = prox_ops.prox_update(
        torch.from_numpy(dx), torch.from_numpy(lam), torch.from_numpy(aux),
        kind="logistic", delta=1.0)
    np.testing.assert_allclose((y + lam_new).numpy(), dx + lam, atol=2e-6)


# The hard grid of the logistic prox: z uniform on [-1000, 1000], z ~ N(0, 9)
# and the edges 0, +-1e-30, +-30, +-88 (expf overflows past 88.7), each with
# labels -1, 0 and 1; deltas from 1e-3 (no bisection step) to 1e3 (ten).
HARD_DELTAS = (1e-3, 0.05, 1.0, 4.0, 10.0, 20.0, 100.0, 1e3)
HARD_LABELS = (-1.0, 0.0, 1.0)


def _hard_grid(n=2000, seed=5):
    """(z, a): the z values once per label in HARD_LABELS, concatenated."""
    rng = np.random.default_rng(seed)
    z = np.concatenate([rng.uniform(-1000.0, 1000.0, n),
                        3.0 * rng.standard_normal(n),
                        [0.0, 1e-30, -1e-30, 30.0, -30.0, 88.0, -88.0]])
    z = z.astype(np.float32)
    a = np.repeat(np.array(HARD_LABELS, np.float32), z.size)
    return np.tile(z, len(HARD_LABELS)), a


def _rel_per_label(got, want, a):
    """max over the labels of max |got - want| / max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return max(float(np.abs(got[a == lab] - want[a == lab]).max()
                     / max(1.0, float(np.abs(want[a == lab]).max())))
               for lab in HARD_LABELS)


@pytest.mark.parametrize("newton_iters", [0, 3, 8])
@pytest.mark.parametrize("delta", HARD_DELTAS)
def test_logistic_mirror_matches_jax_kernel_hard_grid(delta, newton_iters):
    """The kernels' logistic chain (its mirror) against the JAX kernel in
    interpret mode and the plain version (the reference's 40 bisection
    steps): 4e-6 of max(1, max |y|) for each label."""
    J = _jax()
    z, a = _hard_grid()
    yj, _ = J.prox_update(J.jnp.asarray(z), J.jnp.zeros_like(z),
                          J.jnp.asarray(a), kind="logistic", delta=delta,
                          newton_iters=newton_iters, interpret=True,
                          block_rows=8)
    zt, at = torch.from_numpy(z), torch.from_numpy(a)
    ym = logistic_prox_bracketed(zt, delta, at, newton_iters).numpy()
    yp, _ = prox_ops.prox_update(zt, torch.zeros_like(zt), at,
                                 kind="logistic", delta=delta,
                                 newton_iters=newton_iters)
    assert np.isfinite(ym).all()
    assert _rel_per_label(ym, np.asarray(yj), a) <= 4e-6
    assert _rel_per_label(ym, yp.numpy(), a) <= 4e-6


@pytest.mark.parametrize("delta", HARD_DELTAS)
def test_logistic_mirror_within_rounding_band(delta):
    """Element by element, the mirror is within 4 float32 rounding bands of
    the float64 root (``logistic_root_band``), at any newton_iters, as the
    plain version is: the short chain settles where the 40-step one does."""
    z, a = (torch.from_numpy(v) for v in _hard_grid(seed=6))
    root, band = logistic_root_band(z, delta, a)
    for ni in (0, 1, 3, 8):
        ym = logistic_prox_bracketed(z, delta, a, ni).double()
        yp = prox_ops.prox_update_plain(z, torch.zeros_like(z), a,
                                        kind="logistic", delta=delta,
                                        newton_iters=ni)[0].double()
        assert float(((ym - root).abs() / band).max()) <= 4.0, ni
        assert float(((yp - root).abs() / band).max()) <= 4.0, ni


@pytest.mark.parametrize("m", [1000, 4093])
@pytest.mark.parametrize("delta", [1.0, 10.0])
def test_logistic_mirror_matches_plain(m, delta):
    """On the inputs of the parity tests above, atol 2e-6."""
    dx, lam, aux = _inputs(m)
    z = torch.from_numpy(dx) + torch.from_numpy(lam)
    yp, _ = prox_ops.prox_update_plain(torch.from_numpy(dx),
                                       torch.from_numpy(lam),
                                       torch.from_numpy(aux),
                                       kind="logistic", delta=delta)
    ym = logistic_prox_bracketed(z, delta, torch.from_numpy(aux))
    np.testing.assert_allclose(ym.numpy(), yp.numpy(), atol=2e-6)


@pytest.mark.parametrize("label", [-1.0, 1.0])
def test_logistic_mirror_bracket_and_stationarity(label):
    """The bracket (one exp, then bisection) has width at most 1 and holds
    the result; phi'(y) is below 1e-4 at delta = 4, as
    tests/test_prox_properties.py asks of the reference."""
    rng = np.random.default_rng(7)
    z = np.concatenate([np.linspace(-30.0, 30.0, 6001),
                        rng.uniform(-1000.0, 1000.0, 4000),
                        [0.0, 1e-30, -1e-30, 88.0, -88.0]]).astype(np.float32)
    zt = torch.from_numpy(z)
    at = torch.full_like(zt, label)
    for delta in HARD_DELTAS:
        lo, hi = logistic_bracket(zt, delta, at)
        y = logistic_prox_bracketed(zt, delta, at)
        assert float((hi - lo).max()) <= 1.0
        assert bool(((lo <= y) & (y <= hi)).all()), delta
    y = logistic_prox_bracketed(zt, 4.0, at).double()
    zd = zt.double()
    grad = -label / (1.0 + torch.exp(label * y)) + (y - zd) / 4.0
    assert float(grad.abs().max()) < 1e-4


@pytest.mark.cuda
def test_kernel_matches_plain_and_mirror_on_card():
    """K1 on the hard grid against the plain version and the mirror, 4e-6
    of max(1, max |y|) for each label, element by element within 4 float32
    rounding bands of the float64 root, and two identical calls bitwise
    equal (chip_smoke.py's K1 phase holds the same)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    dev = torch.device("cuda")
    zn, an = _hard_grid()
    z, a = torch.from_numpy(zn).to(dev), torch.from_numpy(an).to(dev)
    zero = torch.zeros_like(z)
    for delta in HARD_DELTAS:
        root, band = logistic_root_band(z, delta, a)
        for ni in (0, 3, 8):
            before = prox_ops.prox_update.launches
            y1, l1 = prox_ops.prox_update(z, zero, a, kind="logistic",
                                          delta=delta, newton_iters=ni)
            y2, l2 = prox_ops.prox_update(z, zero, a, kind="logistic",
                                          delta=delta, newton_iters=ni)
            yp, _ = prox_ops.prox_update_plain(z, zero, a, kind="logistic",
                                               delta=delta, newton_iters=ni)
            ym = logistic_prox_bracketed(z, delta, a, ni)
            torch.cuda.synchronize()
            assert prox_ops.prox_update.launches == before + 2
            assert torch.equal(y1, y2) and torch.equal(l1, l2)
            got = y1.cpu().numpy()
            assert _rel_per_label(got, yp.cpu().numpy(), an) <= 4e-6, \
                (delta, ni)
            assert _rel_per_label(got, ym.cpu().numpy(), an) <= 4e-6, \
                (delta, ni)
            assert float(((y1.double() - root).abs() / band).max()) <= 4.0
