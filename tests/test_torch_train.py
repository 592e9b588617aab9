"""Port parity: LM training (``runtime/steps.py::make_train_step``, the
remat and checkpointed cross-entropy of ``models/model.py``, the K4 / K5
autograd guard) against the JAX package.

Mirrors of ``tests/test_models_smoke.py:37`` and ``:64`` for all ten archs
(a forward and a train step on the published smoke config; a loss that
falls over 8 steps on a fixed batch). For every arch at smoke size in f32
compute, the loss and every gradient against ``jax.value_and_grad`` of the
reference's ``loss_fn`` on the same weights (``convert.lm_params``) and
numpy inputs: loss rtol 1e-5, gradients atol 1e-5 / rtol 1e-4 (summation
order only; the largest difference seen is 2.4e-06, rwkv6's ``bonus``);
rwkv6 also at its production WKV chunk, 16, each leaf within 1e-4 of its
largest entry.
One ``make_train_step`` against the reference's, with AdamW and with
Adafactor, and with 2 microbatches on qwen2-vl's M-RoPE batch: loss, grad
norm, params and optimizer state at 1e-5 (except the few parameters of a
first AdamW step whose gradient is within 100 eps of zero, held to the
update's bound: ``_assert_step_close``); a JAX optimizer state carried
across after three reference steps, the fourth step against the
reference's. Remat full, dots and none give the same gradients; MoE's
``DROP_STATS`` counts each layer once under remat.

The vision smoke mirror passes its stub embeddings in the compute type
(bf16): the reference promotes an f32 input through bf16 weights to f32,
which torch's matmul does not do (it raises); the token pipeline gives
bf16 frames either way.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import model as jm
from repro.optim import optimizers as jo
from repro.runtime import steps as jsteps
from repro_torch import convert
from repro_torch.kernels.flash_attn import ops as attn_ops
from repro_torch.kernels.wkv import ops as wkv_ops
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe
from repro_torch.optim import optimizers as to
from repro_torch.runtime import steps as tsteps
from test_torch_models import _batch, _pair_params, _smoke, to_torch_config

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ARCHES = [a.replace("_", "-").replace("1p6b", "1.6b")
          for a in jconfigs.ARCH_IDS]


def _flat(tree, pre=""):
    """(path, tensor or array) pairs of a tree, dicts by sorted key."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], f"{pre}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flat(v, f"{pre}/{i}")]
    return [(pre, tree)]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _assert_trees_close(t, j, atol, rtol=0.0):
    ft, fj = _flat(t), _flat(j)
    assert [p for p, _ in ft] == [p for p, _ in fj]
    for (path, a), (_, b) in zip(ft, fj):
        np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=rtol,
                                   err_msg=path)


def _copy(tree):
    return tm.tree_map(lambda t: t.clone(), tree)


def _grads(tp, tcfg, tb, **kw):
    """(loss, gradient tree) of the port's ``loss_fn`` by autograd."""
    leaves = [t for _, t in _flat(tp)]
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, _ = tm.loss_fn(tp, tcfg, tb, attn_impl="xla", wkv_impl="xla",
                             **kw)
        loss.backward()
        return loss.detach(), tm.tree_map(lambda t: t.grad, tp)
    finally:
        for t in leaves:
            t.grad = None
            t.requires_grad_(False)


# -- mirrors of tests/test_models_smoke.py:37 and :64 -----------------------

def _batch_for(cfg, seed, B=2, S=16):
    """tests/test_models_smoke.py's ``_batch_for`` on numpy: tokens as
    labels, stub patch embeddings (compute type) at 3-stream positions for
    the VLM, stub frames for the encoder-decoder."""
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.frontend == "vision":
        emb = 0.02 * rng.standard_normal((B, S, cfg.d_model))
        batch = {"embeds": torch.from_numpy(emb).to(cfg.compute_dtype),
                 "labels": tokens,
                 "positions": torch.arange(S).expand(3, B, S)}
    elif cfg.family == "encdec":
        batch["enc_embeds"] = torch.from_numpy(
            0.02 * rng.standard_normal((B, S, cfg.d_model))).float()
    return batch


def _init(cfg, seed):
    return tm.init_params(cfg, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("arch", ARCHES)
def test_smoke_forward_and_train_step(arch):
    cfg = tconfigs.get_smoke(arch)
    params = _init(cfg, 0)
    batch = _batch_for(cfg, 0)
    with torch.no_grad():
        h, _ = tm.forward(params, cfg, **{
            k: v for k, v in batch.items() if k != "labels"})
    assert h.shape == (2, 16, cfg.d_model)
    assert bool(torch.isfinite(h.float()).all()), arch

    opt = to.make_optimizer(cfg.optimizer, lr=1e-3, warmup_steps=1,
                            total_steps=10)
    before = _copy(params)
    step_fn = tsteps.make_train_step(cfg, opt)
    params2, opt_state, metrics = step_fn(params, opt.init(params), batch, 0)
    assert np.isfinite(float(metrics["loss"])), arch
    assert float(metrics["grad_norm"]) > 0, arch
    assert set(metrics) == {"loss", "grad_norm", "ce", "aux"}
    assert all(m.dim() == 0 for m in metrics.values())
    # params actually moved (in place: params2 is params)
    assert params2 is params
    delta = sum(float((a.float() - b.float()).abs().sum())
                for (_, a), (_, b) in zip(_flat(before), _flat(params2)))
    assert delta > 0, arch
    assert not any(t.requires_grad or t.grad is not None
                   for _, t in _flat(params2))


@pytest.mark.parametrize("arch", ARCHES)
def test_smoke_loss_decreases(arch):
    """A few steps on a fixed batch must reduce the loss (end-to-end grad
    correctness through every family's sequence mixer)."""
    cfg = tconfigs.get_smoke(arch)
    params = _init(cfg, 1)
    batch = _batch_for(cfg, 1)
    opt = to.make_optimizer("adamw", lr=3e-3, warmup_steps=0,
                            total_steps=100)
    step_fn = tsteps.make_train_step(cfg, opt)
    opt_state = opt.init(params)
    losses = []
    for i in range(8):
        params, opt_state, metrics = step_fn(params, opt_state, batch, i)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], (arch, losses)


# -- loss and gradients against jax.value_and_grad --------------------------

# every smoke config, and rwkv6 at its production WKV chunk (16, where the
# separable decay factors reach e^80) and head dim 64
GRAD_CASES = [(a, {}) for a in jconfigs.ARCH_IDS] + [
    ("rwkv6_1p6b", dict(wkv_chunk=16, d_model=128, num_heads=2,
                        num_kv_heads=2, rwkv_head_dim=64))]


@pytest.mark.parametrize("arch,over", GRAD_CASES,
                         ids=[a + "".join(f"-{k}{v}" for k, v in o.items()
                                          if k == "wkv_chunk")
                              for a, o in GRAD_CASES])
def test_loss_and_gradients_match_reference_f32(arch, over):
    jcfg = dataclasses.replace(_smoke(arch, jnp.float32), **over)
    tcfg = to_torch_config(jcfg)
    jp, tp = _pair_params(jcfg)
    jb, tb = _batch(jcfg, 2, 32)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jcfg, jb), has_aux=True))(jp)
    tloss, tg = _grads(tp, tcfg, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    if not over:
        _assert_trees_close(tg, jg, atol=1e-5, rtol=1e-4)
    else:
        # at chunk 16 the separable form scales r and k by e^(+-cum), up to
        # e^80, and both packages' f32 sums carry that rounding: each leaf
        # is held to 1e-4 of its largest entry (seen: 1.6e-05 at most)
        for (path, a), (_, b) in zip(_flat(tg), _flat(jg)):
            scale = float(np.abs(_np(b)).max())
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-4 * scale,
                                       err_msg=path)
    # every leaf gets a gradient
    assert all(float(g.abs().max()) > 0 for _, g in _flat(tg)), arch


# -- the train step against the reference's ---------------------------------

def _step_pair(arch, name, mb=1, **kw):
    jcfg = _smoke(arch, jnp.float32)
    tcfg = to_torch_config(jcfg)
    jopt = jo.make_optimizer(name, lr=1e-3, warmup_steps=1, total_steps=10,
                             **kw)
    topt = to.make_optimizer(name, lr=1e-3, warmup_steps=1, total_steps=10,
                             **kw)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt, microbatches=mb))
    tstep = tsteps.make_train_step(tcfg, topt, microbatches=mb)
    return jcfg, tcfg, jopt, topt, jstep, tstep


def _assert_step_close(tout, jout, tol=1e-5, adam_first=None):
    """Metrics, params and state at ``tol``. ``adam_first`` (an AdamW
    ``(lr, b1, eps)``) marks a first AdamW step, whose update is
    g / (|g| + eps): where the clipped gradient lies within 100 eps of 0, a
    difference of ~1e-9 in g (summation order; the gradient test) moves it
    by up to O(1) x lr. There, and only there (found from the reference's
    first moment, m = (1 - b1) g; at most 1e-3 of the elements, a gradient of
    exactly 0 not among them), params are
    held to the bound of the update itself, 2 lr."""
    (tp, ts, tmet), (jp, js, jmet) = tout, jout
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=tol,
                                   atol=1e-7, err_msg=k)
    _assert_trees_close(ts, js, atol=tol)
    if adam_first is None:
        _assert_trees_close(tp, jp, atol=tol)
        return
    lr, b1, eps = adam_first
    near, total = 0, 0
    for (path, a), (_, b), (_, m) in zip(_flat(tp), _flat(jp),
                                         _flat(js["m"])):
        g = np.abs(_np(m)) / (1 - b1)
        flat = (g < 100 * eps) & (g > 0)    # 0: a token outside the batch
        d = np.abs(_np(a) - _np(b))
        assert (d[~flat] <= tol).all(), (path, d[~flat].max())
        assert (d[flat] <= 2 * lr).all(), path
        near, total = near + flat.sum(), total + flat.size
    assert near <= 1e-3 * total, (near, total)


@pytest.mark.parametrize("name,arch,mb", [
    ("adamw", "qwen3-8b", 1), ("adafactor", "qwen3-8b", 1),
    ("adamw", "qwen2-vl-72b", 2), ("adamw", "olmoe-1b-7b", 1)])
def test_train_step_matches_reference(name, arch, mb):
    """One step from the same params and batch: metrics, params and state
    at 1e-5 (AdamW: see ``_assert_step_close``). qwen2-vl's batch carries
    (3, B, S) M-RoPE positions, which the microbatches split along axis
    1."""
    jcfg, tcfg, jopt, topt, jstep, tstep = _step_pair(arch, name, mb)
    jp, tp = _pair_params(jcfg)
    jb, tb = _batch(jcfg, 4, 32)
    if mb > 1:
        assert tb["positions"].shape == (3, 4, 32)
    jout = jstep(jp, jopt.init(jp), jb, jnp.asarray(0, jnp.int32))
    tout = tstep(tp, topt.init(tp), tb, 0)
    adam = (float(jopt.schedule(0)), jopt.b1, jopt.eps) \
        if name == "adamw" else None
    _assert_step_close(tout, jout, adam_first=adam)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_carried_reference_state_continues(name):
    """Three reference steps; params and optimizer state carried by
    ``convert.lm_params`` (it takes the state trees as they are); the
    port's fourth step against the reference's fourth."""
    jcfg, tcfg, jopt, topt, jstep, tstep = _step_pair("qwen3-8b", name)
    jp, _ = _pair_params(jcfg)
    js = jopt.init(jp)
    for i in range(3):
        jb, _ = _batch(jcfg, 2, 32, seed=10 + i)
        jp, js, _ = jstep(jp, js, jb, jnp.asarray(i, jnp.int32))
    host = jax.tree.map(np.asarray, (jp, js))
    tp = convert.lm_params(host[0], device="cpu")
    ts = convert.lm_params(host[1], device="cpu")
    _assert_trees_close(ts, js, atol=0)
    jb, tb = _batch(jcfg, 2, 32, seed=13)
    jout = jstep(jp, js, jb, jnp.asarray(3, jnp.int32))
    _assert_step_close(tstep(tp, ts, tb, 3), jout)


# -- remat ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-1.6b", "olmoe-1b-7b",
                                  "seamless-m4t-large-v2",
                                  "recurrentgemma-9b"])
def test_remat_modes_give_the_same_gradients(arch):
    """remat "full", "dots" and "none": the same loss and gradients, bit
    for bit (recomputing a layer repeats its ops); a forward without grad
    takes no checkpoint and gives the same hidden states."""
    base = dataclasses.replace(tconfigs.get_smoke(arch),
                               compute_dtype=torch.float32)
    params = _init(base, 2)
    batch = _batch_for(base, 2, S=32)
    out = {}
    for mode in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=mode)
        out[mode] = _grads(params, cfg, batch)
        with torch.no_grad():
            out[mode] += (tm.forward(params, cfg, **{
                k: v for k, v in batch.items() if k != "labels"})[0],)
    for mode in ("full", "dots"):
        assert torch.equal(out[mode][0], out["none"][0]), mode
        assert torch.equal(out[mode][2], out["none"][2]), mode
        for (p, a), (_, b) in zip(_flat(out[mode][1]), _flat(out["none"][1])):
            assert torch.equal(a, b), (mode, p)


def test_remat_checkpoints_each_layer_only_under_grad(monkeypatch):
    """The checkpoint wraps every layer, and the cross-entropy chunks, only
    while grad is enabled; "none" wraps only the chunks."""
    calls = []
    real = tm.checkpoint
    monkeypatch.setattr(tm, "checkpoint",
                        lambda fn, *a, **k: calls.append(fn) or real(
                            fn, *a, **k))
    cfg = tconfigs.get_smoke("qwen3-8b")
    params = _init(cfg, 3)
    batch = _batch_for(cfg, 3, S=32)
    with torch.no_grad():
        tm.loss_fn(params, cfg, batch)
    assert calls == []
    _grads(params, cfg, batch)
    assert len(calls) == cfg.num_layers + 1          # + one CE chunk
    calls.clear()
    _grads(params, dataclasses.replace(cfg, remat="none"), batch)
    assert len(calls) == 1


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_drop_stats_count_each_layer_once(remat, monkeypatch):
    """MoE's DROP_STATS gets one entry a layer per forward, with remat on
    (whose backward recomputes every layer) as with it off, and the same
    counts."""
    cfg = dataclasses.replace(tconfigs.get_smoke("olmoe-1b-7b"),
                              compute_dtype=torch.float32, remat=remat)
    params = _init(cfg, 4)
    batch = _batch_for(cfg, 4, S=32)
    monkeypatch.setattr(tmoe, "DROP_STATS", [])
    _grads(params, cfg, batch)
    stats = [(int(k), n) for k, n in tmoe.DROP_STATS]
    assert len(stats) == cfg.num_layers
    monkeypatch.setattr(tmoe, "DROP_STATS", [])
    with torch.no_grad():
        tm.loss_fn(params, cfg, batch)
    assert [(int(k), n) for k, n in tmoe.DROP_STATS] == stats


# -- the K4 / K5 guard --------------------------------------------------------

def test_kernels_raise_under_grad_rather_than_drop_gradients():
    """impl="cuda" has no backward: with grad enabled and an input that
    requires grad, K4 and K5 raise on every device (here the CPU, where
    their plain versions would otherwise run) and name the chunked path;
    without grad, or without such an input, they run."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 8, 16), generator=g) for _ in range(3))
    w = -torch.rand((1, 2, 8, 16), generator=g)
    u = torch.randn((2, 16), generator=g)
    attn_ops.flash_attention(q, k, v)
    wkv_ops.wkv(q, k, v, w, u, chunk=4)
    qg = q.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="attn_impl='xla'"):
        attn_ops.flash_attention(qg, k, v)
    with pytest.raises(RuntimeError, match="wkv_impl='xla'"):
        wkv_ops.wkv(q, k, v, w, u.clone().requires_grad_(True), chunk=4)
    with torch.no_grad():
        attn_ops.flash_attention(qg, k, v)
        wkv_ops.wkv(qg, k, v, w, u, chunk=4)
    o = attn_ops.flash_attention(qg, k, v, impl="xla")
    assert o.requires_grad
    # the model on its defaults ("cuda") with params that require grad
    for arch in ("qwen3-8b", "rwkv6-1.6b"):
        cfg = tconfigs.get_smoke(arch)
        params = _init(cfg, 5)
        for _, t in _flat(params):
            t.requires_grad_(True)
        with pytest.raises(RuntimeError, match="has no backward"):
            tm.loss_fn(params, cfg, _batch_for(cfg, 5))
