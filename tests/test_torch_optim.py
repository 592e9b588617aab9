"""Port parity: ``repro_torch.optim.optimizers`` against the JAX package's
``repro.optim.optimizers``.

The mirrors of ``tests/test_roofline_and_optim.py:78-115`` (a quadratic
the optimizers must descend, Adafactor's factored state, AdamW's weight
decay) on the same A and b; AdamW's and Adafactor's updates against the
reference's on one random tree with 1-D, 2-D and stacked 3-D leaves (and a
list of segments, as the LM's ``blocks``) over three steps, params and
state at 1e-6 (f32 rounding: pow, mean and cos may differ by an ulp between
the packages); both schedules at steps through warm-up, decay and past the
end. The port's update writes in place and returns the same tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jo
from repro_torch import convert
from repro_torch.optim import optimizers as to

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

SHAPES = {"w": (16, 8), "stack": (3, 8, 4), "b": (7,),
          "blocks": [{"x": (2, 5, 6), "n": (2, 5)}, {"y": (4, 3)}]}


def _tree(seed, scale=1.0):
    """A numpy tree of SHAPES' layout drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        if isinstance(s, list):
            return [make(v) for v in s]
        return (scale * rng.standard_normal(s)).astype(np.float32)
    return make(SHAPES)


def _flat(tree):
    """(path, numpy array) pairs of a JAX or torch tree, by sorted key."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}", a) for k in sorted(tree)
                for p, a in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}/{p}", a) for i, v in enumerate(tree)
                for p, a in _flat(v)]
    if isinstance(tree, torch.Tensor):
        return [("", tree.detach().numpy())]
    return [("", np.asarray(tree))]


def _assert_trees_close(t, j, tol):
    ft, fj = _flat(t), _flat(j)
    assert [p for p, _ in ft] == [p for p, _ in fj]
    for (path, a), (_, b) in zip(ft, fj):
        assert a.shape == b.shape, path
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=path)


# -- mirrors of tests/test_roofline_and_optim.py:78-115 ---------------------

def _quadratic_problem():
    A = np.array(jax.random.normal(jax.random.PRNGKey(0), (20, 10)) / 5.0)
    b = np.array(jax.random.normal(jax.random.PRNGKey(1), (20,)))
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    params = {"w": torch.zeros((10, 4)), "b": torch.zeros((4,))}

    def loss(p):
        pred = At @ p["w"] + p["b"]
        return torch.mean((pred - bt[:, None]) ** 2)

    return params, loss, A, b


@pytest.mark.parametrize("opt", [
    to.AdamW(lr=0.05, warmup_steps=0, total_steps=400, weight_decay=0.0),
    to.Adafactor(lr=0.5, warmup_steps=0, total_steps=400),
])
def test_optimizer_decreases_quadratic(opt):
    params, loss, A, b = _quadratic_problem()
    A1 = np.concatenate([A, np.ones((20, 1), np.float32)], axis=1)
    w, *_ = np.linalg.lstsq(A1, b, rcond=None)
    l_star = float(np.mean((A1 @ w - b) ** 2))
    state = opt.init(params)
    l0 = float(loss(params))
    for i in range(200):
        for p in params.values():
            p.requires_grad_(True)
        g = dict(zip(params, torch.autograd.grad(loss(params),
                                                 list(params.values()))))
        for p in params.values():
            p.requires_grad_(False)
        params, state = opt.update(g, state, params, i)
    l_end = float(loss(params))
    # Adafactor (no momentum, RMS-clipped steps) converges slower on this
    # anisotropic quadratic: the reference's looser gate.
    frac = 0.25 if isinstance(opt, to.AdamW) else 0.55
    assert l_end < l_star + frac * (l0 - l_star), (l_end, l_star, l0)


def test_adafactor_state_is_factored():
    params = {"w": torch.zeros((64, 32)), "stack": torch.zeros((4, 16, 8)),
              "b": torch.zeros((7,))}
    st = to.Adafactor().init(params)
    assert st["f"]["w"]["vr"].shape == (64,)
    assert st["f"]["w"]["vc"].shape == (32,)
    assert st["f"]["stack"]["vr"].shape == (4, 16)
    assert st["f"]["stack"]["vc"].shape == (4, 8)
    assert st["f"]["b"]["v"].shape == (7,)
    n_state = sum(a.size for _, a in _flat(st))
    n_param = sum(a.size for _, a in _flat(params))
    assert n_state < 0.2 * n_param  # the arctic-480b memory plan


def test_adamw_weight_decay_shrinks():
    opt = to.AdamW(lr=0.1, weight_decay=0.5, warmup_steps=0, total_steps=10)
    params = {"w": torch.ones((4,))}
    state = opt.init(params)
    g = {"w": torch.zeros((4,))}
    p2, _ = opt.update(g, state, params, 5)
    assert float(p2["w"][0]) < 1.0


# -- updates and schedules against the reference ----------------------------

OPTS = [
    ("adamw", dict(lr=3e-2, warmup_steps=2, total_steps=10)),
    ("adafactor", dict(lr=3e-2, warmup_steps=2, total_steps=10)),
    ("adafactor", dict(lr=1e-1, warmup_steps=0, clip_threshold=0.5)),
]


@pytest.mark.parametrize("name,kw", OPTS)
def test_update_matches_reference(name, kw):
    """Three updates from the same params with three gradient trees: params
    and state against the reference's at 1e-6; the port's tensors are
    updated in place."""
    jopt, topt = jo.make_optimizer(name, **kw), to.make_optimizer(name, **kw)
    p0 = _tree(0)
    jp = jax.tree.map(jnp.asarray, p0)
    w0 = p0["w"].copy()    # the CPU tensors share p0's memory
    tp = convert.lm_params(p0, device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    _assert_trees_close(ts, js, 0)
    w_before = tp["w"]
    for step in range(3):
        g = _tree(10 + step, scale=0.1 * (step + 1))
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                             jnp.asarray(step, jnp.int32))
        tp2, ts2 = topt.update(convert.lm_params(g, device="cpu"), ts, tp,
                               step)
        assert tp2 is tp and ts2 is ts and tp["w"] is w_before
        _assert_trees_close(tp, jp, 1e-6)
        _assert_trees_close(ts, js, 1e-6)
    assert not np.allclose(tp["w"].numpy(), w0)


def test_update_continues_from_carried_reference_state():
    """A reference state tree (sorted keys, as ``jax.tree.map`` leaves it)
    carried by ``convert.lm_params`` pairs with params of another key
    order: matched by key, the next update equals the reference's."""
    for name in ("adamw", "adafactor"):
        jopt = jo.make_optimizer(name, lr=1e-2, warmup_steps=0)
        topt = to.make_optimizer(name, lr=1e-2, warmup_steps=0)
        jp = jax.tree.map(jnp.asarray, _tree(1))
        js = jopt.init(jp)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, _tree(2, 0.1)), js,
                             jp, jnp.asarray(0, jnp.int32))
        tp = convert.lm_params(jax.tree.map(np.asarray, jp), device="cpu")
        tp = {k: tp[k] for k in reversed(list(tp))}    # another key order
        ts = convert.lm_params(jax.tree.map(np.asarray, js), device="cpu")
        g = _tree(3, 0.1)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                             jnp.asarray(1, jnp.int32))
        topt.update(convert.lm_params(g, device="cpu"), ts, tp, 1)
        _assert_trees_close(tp, jp, 1e-6)
        _assert_trees_close(ts, js, 1e-6)


def test_schedules_match_reference():
    steps = [0, 1, 5, 9, 10, 11, 37, 50, 99, 100, 150]
    for cls, kw in ((jo.AdamW, dict(lr=3e-3, warmup_steps=10,
                                    total_steps=100)),
                    (jo.AdamW, dict(lr=1e-3, warmup_steps=0, total_steps=1)),
                    (jo.Adafactor, dict(lr=2e-2, warmup_steps=10))):
        jopt = cls(**kw)
        topt = getattr(to, cls.__name__)(**kw)
        for s in steps:
            want = float(jopt.schedule(jnp.asarray(s, jnp.int32)))
            got = topt.schedule(s)
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(float(got), want, rtol=1e-6,
                                       err_msg=f"{cls.__name__} step {s}")


def test_make_optimizer_names():
    assert isinstance(to.make_optimizer("adamw", lr=1.0), to.AdamW)
    assert isinstance(to.make_optimizer("adafactor"), to.Adafactor)
    with pytest.raises(ValueError):
        to.make_optimizer("sgd")
