"""Port parity of the problem surface: every ``(problem, method)`` key of
the registry through ``fit()``, the stats-path solvers, problems on the
local executor, and the fitting CLI, against the JAX package on the same
numpy arrays.

Tolerances: the ADMM entries ``tests/test_engine.py:110`` (x rel 2e-4,
objective rel 1e-4; DESIGN.md section 3 lets the stop iteration differ by
a few), FASTA entries ``tests/test_engine.py:163`` (x rtol 1e-3 / atol
1e-5), ridge's closed form rel 1e-5, the consensus lasso and logistic
1e-5, the consensus SVM the reference's own rounding spread
(``tests/test_torch_consensus.py``).
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core.fit import fit as tfit
from repro_torch.core import consensus as tcons
from repro_torch.exec import problems as tprob
from repro_torch.launch import fit as fit_cli
from repro_torch.service import registry as treg

torch.set_num_threads(1)

ADMM = ("logistic", "svm", "sparse_logistic", "huber", "quantile",
        "group_lasso", "multinomial")
FASTA = ("lasso", "elastic_net", "nnls")
KEYS = sorted(treg._REGISTRY)
EXEC_PROBLEMS = ("logistic", "svm", "least_squares", "quantile",
                 "group_lasso", "multinomial")


@functools.lru_cache(maxsize=None)
def _jax():
    import jax
    import jax.numpy as jnp
    from repro.core.fit import fit as jfit
    from repro.data.synthetic import classification_problem, lasso_problem
    from repro.exec import problems as jprob
    from repro.service import registry as jreg
    jax.config.update("jax_platform_name", "cpu")
    return SimpleNamespace(jax=jax, jnp=jnp, fit=jfit, reg=jreg,
                           prob=jprob, classif=classification_problem,
                           lasso=lasso_problem)


@functools.lru_cache(maxsize=None)
def _arrays():
    """Shared numpy inputs at the JAX tests' size (N 4 x m_i 250 x n 20):
    a lasso problem, a two-class problem, three-class labels."""
    J = _jax()
    lp = J.lasso(J.jax.random.PRNGKey(0), N=4, m_per_node=250, n=20)
    cp = J.classif(J.jax.random.PRNGKey(0), N=4, m_per_node=250, n=20)
    cls = np.random.default_rng(0).integers(0, 3, (4, 250)).astype(
        np.float32)
    return SimpleNamespace(D_l=np.array(lp.D), b=np.array(lp.b),
                           mu=float(lp.mu), D_c=np.array(cp.D),
                           lab=np.array(cp.labels), cls=cls)


def _call(problem):
    """(D, aux, kwargs) of one problem."""
    a = _arrays()
    kw = dict(iters=60)
    if problem in ("lasso", "ridge", "elastic_net", "nnls", "huber",
                   "quantile", "group_lasso"):
        D, aux = a.D_l, a.b
    elif problem == "multinomial":
        D, aux = a.D_c, a.cls
    else:
        D, aux = a.D_c, a.lab
    if problem in ("lasso", "elastic_net", "group_lasso"):
        kw["mu"] = a.mu
    if problem == "sparse_logistic":
        kw["mu"] = 2.0
    if problem == "elastic_net":
        kw["l2"] = 0.1 * a.mu
    return D, aux, kw


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_registry_keys_match_jax():
    jkeys = sorted(_jax().reg._REGISTRY)
    assert KEYS == jkeys and len(KEYS) == 19
    assert treg.problems() == _jax().reg.problems()
    for p in treg.problems():
        assert treg.methods(p) == _jax().reg.methods(p)
        for m in treg.methods(p):
            assert treg.get_solver(p, m).gram_path == \
                _jax().reg.get_solver(p, m).gram_path
    assert sorted(treg.GRAM_SOLVERS) == sorted(_jax().reg.GRAM_SOLVERS)


@pytest.mark.parametrize("problem,method", KEYS,
                         ids=[f"{p}-{m}" for p, m in KEYS])
def test_registry_key_matches_jax(problem, method):
    J = _jax()
    D, aux, kw = _call(problem)
    rj = J.fit(problem, J.jnp.asarray(D), J.jnp.asarray(aux), method=method,
               **kw)
    rt = tfit(problem, D, aux, method=method, device="cpu", **kw)
    assert (rt.problem, rt.method) == (rj.problem, rj.method)
    assert tuple(rt.x.shape) == tuple(np.asarray(rj.x).shape)
    assert rt.x.device.type == "cpu" and bool(torch.isfinite(rt.x).all())
    hj = None if rj.objective_history is None else \
        np.asarray(rj.objective_history)
    if hj is None:
        assert rt.objective_history is None
    else:
        assert rt.objective_history.shape == hj.shape
    ht = None if hj is None else rt.objective_history.numpy()
    if problem == "ridge":
        assert _rel(rt.x, rj.x) <= 1e-5 and rt.iters == 1
    elif method == "consensus" and problem == "svm":
        D64, a64 = torch.from_numpy(D).double(), torch.from_numpy(aux)
        r64 = tcons.ConsensusSVM(C=1.0, tau=kw.get("tau") or 0.5).run(
            D64, a64.double(), kw["iters"])
        assert _rel(rt.x, rj.x) <= 3 * _rel(rj.x, r64.z) + 1e-5
        assert rt.iters == int(rj.iters)
    elif method == "consensus":
        assert _rel(rt.x, rj.x) <= 1e-5 and rt.iters == int(rj.iters)
        np.testing.assert_allclose(ht, hj, rtol=1e-5)
    elif problem in FASTA:
        np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x),
                                   rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(ht, hj, rtol=1e-5,
                                   atol=1e-5 * np.abs(hj).max())
    else:
        assert problem in ADMM
        assert abs(rt.iters - int(rj.iters)) <= 3
        k = min(rt.iters, int(rj.iters), len(ht))
        assert np.max(np.abs(ht[:k] - hj[:k]) / np.abs(hj[:k])) < 1e-4
        if rt.iters == int(rj.iters):
            assert _rel(rt.x, rj.x) < 2e-4


@pytest.mark.parametrize("problem", ["ridge", "lasso", "elastic_net",
                                     "nnls"])
def test_gram_solvers_match_jax(problem):
    J = _jax()
    a = _arrays()
    D2, b2 = a.D_l.reshape(-1, 20), a.b.reshape(-1)
    G = (D2.astype(np.float64).T @ D2).astype(np.float32)
    c = (D2.astype(np.float64).T @ b2).astype(np.float32)
    kw = {"ridge": dict(mu=2.0), "lasso": dict(mu=a.mu, iters=300),
          "elastic_net": dict(mu=a.mu, l2=0.3 * a.mu, iters=300),
          "nnls": dict(iters=300)}[problem]
    xj, itj, hj = J.reg.GRAM_SOLVERS[problem](J.jnp.asarray(G),
                                              J.jnp.asarray(c), **kw)
    xt, itt, ht = treg.GRAM_SOLVERS[problem](torch.from_numpy(G),
                                             torch.from_numpy(c), **kw)
    if problem == "ridge":
        assert _rel(xt, xj) <= 1e-5 and (itt, ht, hj) == (1, None, None)
        want = np.linalg.solve(G.astype(np.float64) + 2.0 * np.eye(20), c)
        assert _rel(xt, want) <= 1e-5
        return
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-3,
                               atol=1e-5)
    assert ht.shape == (300,)


@pytest.mark.parametrize("name", EXEC_PROBLEMS)
def test_make_problem_on_local_matches_jax(name):
    J = _jax()
    jp, tp = J.prob.make_problem(name), tprob.make_problem(name)
    assert (tp.name, tp.loss_spec, tp.tau, tp.rho) == \
        (jp.name, jp.loss_spec, jp.tau, jp.rho)
    D, aux = J.prob.synth_data(jp, m=200, n=12, seed=3)
    Dt, at = tprob.synth_data(tp, m=200, n=12, seed=3)
    np.testing.assert_array_equal(D, Dt)
    np.testing.assert_array_equal(aux, at)
    rj = J.prob.fit_on_executor(jp, "local", D, aux, max_iters=300,
                                record=True)
    rt = tprob.fit_on_executor(tp, "local", D, aux, max_iters=300,
                               record=True, device="cpu")
    assert tuple(rt.x.shape) == tuple(np.asarray(rj.x).shape)
    assert tuple(rt.y.shape) == tuple(np.asarray(rj.y).shape)
    assert abs(rt.iters - int(rj.iters)) <= 3
    k = min(rt.iters, int(rj.iters))
    hj = np.asarray(rj.history.objective)[:k]
    assert np.max(np.abs(rt.history.objective.numpy()[:k] - hj)
                  / np.abs(hj)) < 1e-4
    if rt.iters == int(rj.iters):
        assert _rel(rt.x, rj.x) < 2e-4


def test_multinomial_x_is_n_by_K():
    a = _arrays()
    r = tfit("multinomial", a.D_c, a.cls, classes=3, iters=20, device="cpu")
    assert tuple(r.x.shape) == (20, 3)
    ex = tprob.make_executor("local", tprob.make_problem("multinomial"),
                             a.D_c.reshape(-1, 20), a.cls.reshape(-1),
                             device="cpu")
    assert ex.ycols == 3 and tuple(ex.zero_x().shape) == (20, 3)
    ex.setup()
    ex.init(None)
    y, lam = ex.final_iterates()
    assert tuple(y.shape) == tuple(lam.shape) == (1, 1000, 3)


def test_unknown_problems_and_executors_raise():
    a = _arrays()
    for fn in (lambda: tfit("poisson", a.D_l, a.b, device="cpu"),
               lambda: tfit("ridge", a.D_l, a.b, method="consensus",
                            device="cpu"),
               lambda: tprob.make_problem("poisson"),
               lambda: tprob.make_executor(
                   "cluster", tprob.make_problem("logistic"), a.D_c,
                   device="cpu"),
               lambda: tprob.make_executor(
                   "mesh", tprob.make_problem("logistic"), a.D_c,
                   device="cpu")):
        with pytest.raises(ValueError):
            fn()
    with pytest.raises(ValueError, match="unsupported"):
        treg.get_solver("svm", "fasta")
    # the shard_map executor (ROADMAP item 8) is ported: outside a process
    # group it runs a world of one that starts no process group
    ex = tprob.make_executor("shard_map", tprob.make_problem("logistic"),
                             a.D_c, a.lab, device="cpu")
    assert ex.name == "shard_map" and ex.world == 1 and ex.pad == 0
    assert ex.extra_record() == {"shards": 1, "backend": "none"}
    assert not torch.distributed.is_initialized()
    # the streaming executor (ROADMAP item 7) is ported
    ex = tprob.make_executor("streaming", tprob.make_problem("logistic"),
                             a.D_c.reshape(-1, 20), a.lab.reshape(-1),
                             device="cpu", block_rows=300)
    assert ex.name == "streaming" and ex.store.block_rows == 300
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        tprob.fit_on_executor(tprob.make_problem("logistic"), "cluster",
                              a.D_c, a.lab)
    with pytest.raises(ValueError, match="needs mu"):
        tfit("lasso", a.D_l, a.b, device="cpu")


def test_fit_takes_numpy_or_tensors_and_defaults_to_cuda(monkeypatch):
    a = _arrays()
    r1 = tfit("lasso", a.D_l, a.b, mu=a.mu, iters=50, device="cpu")
    r2 = tfit("lasso", torch.from_numpy(a.D_l), torch.from_numpy(a.b),
              mu=a.mu, iters=50, device="cpu")
    assert torch.equal(r1.x, r2.x)
    import inspect
    assert inspect.signature(tfit).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfit("lasso", a.D_l, a.b, mu=a.mu)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprob.make_executor("local", tprob.make_problem("logistic"), a.D_c)


@pytest.mark.parametrize("method", ["transpose", "fasta", "consensus"])
def test_fit_cli_lasso_cpu(capsys, method):
    res = fit_cli.main(["--device", "cpu", "--problem", "lasso",
                        "--method", method, "--nodes", "4",
                        "--rows-per-node", "300", "--features", "20",
                        "--heterogeneous", "--iters", "200"])
    out = capsys.readouterr().out
    assert f"[{method}] lasso:" in out and "KKT violation:" in out \
        and "support err:" in out
    assert bool(torch.isfinite(res.x).all())
    viol = float(out.split("KKT violation: ")[1].split(",")[0])
    if method != "consensus":
        assert viol < 1e-2


def test_fit_cli_consensus_classifiers_and_mu(capsys):
    fit_cli.main(["--device", "cpu", "--problem", "logistic", "--method",
                  "consensus", "--nodes", "2", "--rows-per-node", "200",
                  "--features", "8", "--iters", "20"])
    assert "[consensus] logistic:" in capsys.readouterr().out
    fit_cli.main(["--device", "cpu", "--problem", "sparse_logistic",
                  "--mu", "3.0", "--nodes", "2", "--rows-per-node", "200",
                  "--features", "8", "--iters", "30"])
    assert "train acc:" in capsys.readouterr().out


@pytest.mark.cuda
def test_lasso_fit_launches_k2b_once_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    from repro_torch.data.synthetic import lasso_problem
    from repro_torch.kernels.gram import ops as gram_ops
    p = lasso_problem(0, 4, 2000, 40)
    for problem, kw in (("lasso", dict(mu=float(p.mu))),
                        ("ridge", {}), ("nnls", {}),
                        ("elastic_net", dict(mu=float(p.mu), l2=0.1))):
        before = gram_ops.gram_and_rhs.launches
        r = tfit(problem, p.D, p.b, iters=300, **kw)
        torch.cuda.synchronize()
        assert gram_ops.gram_and_rhs.launches == before + 1, problem
        assert r.x.device.type == "cuda"
        c = tfit(problem, p.D.cpu(), p.b.cpu(), iters=300, device="cpu",
                 **kw)
        np.testing.assert_allclose(r.x.cpu().numpy(), c.x.numpy(),
                                   rtol=1e-3, atol=1e-5)


@pytest.mark.cuda
def test_shard_map_on_the_card_matches_the_local_solve():
    """Two gloo ranks sharing the card (K2a once and K3 every iteration on
    each rank's rows) against the local solve on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    from repro_torch.exec.shard_map import fit_rank
    from repro_torch.sharding import compat
    prob = tprob.make_problem("logistic")
    D, aux = tprob.synth_data(prob, m=20_001, n=37, seed=5)
    kw = dict(max_iters=60, eps_rel=1e-12, eps_abs=1e-15)
    ref = tprob.fit_on_executor(prob, "local", D, aux, device="cuda", **kw)
    ranks = compat.spawn(fit_rank, 2, compat.layout_backend("cuda", 2),
                         args=([dict(problem="logistic", D=D, aux=aux,
                                     **kw)], "cuda"),
                         device="cuda", timeout=300)
    x = ranks[0][0]["x"]
    assert np.array_equal(x.view(np.uint32), ranks[1][0]["x"].view(np.uint32))
    x_ref = ref.x.cpu().numpy()
    gap = np.abs(x - x_ref).max() / max(1.0, np.abs(x_ref).max())
    assert ranks[0][0]["iters"] == 60 and gap <= 1e-5, gap
