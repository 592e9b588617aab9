"""Port parity for the whole slice: ``UnwrappedADMM.run`` / ``solve`` of
``repro_torch`` against the JAX package's ``UnwrappedADMM`` (chunked
backend) on the same numpy data, with the tolerances of
``tests/test_engine.py:110`` (x rel 2e-4, objective rel 1e-4; DESIGN.md
section 3 lets the stop iteration differ by a few), plus warm start, the
carry-across of a JAX solve's state through ``convert.py``, the composite
(l1) x-update, the data generators and the reduced CLI."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prox as jprox
from repro.core.unwrapped import UnwrappedADMM as JADMM
from repro.data.synthetic import classification_problem as j_classif
from repro.data.synthetic import lasso_problem as j_lasso
from repro.exec import make_l1_reg as j_l1_reg
from repro_torch import convert
from repro_torch.core import prox as tprox
from repro_torch.core.unwrapped import UnwrappedADMM, flat_to_nodes
from repro_torch.data import synthetic
from repro_torch.exec import make_l1_reg
from repro_torch.launch import fit as fit_cli

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

PROBLEMS = {
    "logistic": (dict(tau=0.1), jprox.make_logistic, tprox.make_logistic,
                 60),
    "svm": (dict(tau=0.5, rho=1.0), lambda: jprox.make_hinge(1.0),
            lambda: tprox.make_hinge(1.0), 80),
}


@pytest.fixture(scope="module")
def classif():
    p = j_classif(jax.random.PRNGKey(0), N=4, m_per_node=250, n=20)
    return np.array(p.D), np.array(p.labels)


def _solvers(problem, backend="cuda", **extra):
    """The pair of solvers. eps_abs = 1e-4 puts the stopping tolerance
    above the f32 noise floor of the residuals (~1e-5 here), so the stop
    iteration is set by the trajectory and not by rounding."""
    kw, jl, tl, iters = PROBLEMS[problem]
    kw = dict(kw, eps_abs=1e-4)
    return (JADMM(loss=jl(), backend="chunked", **kw),
            UnwrappedADMM(loss=tl(), backend=backend, device="cpu", **kw,
                          **extra), iters)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("backend", ["reference", "chunked", "cuda"])
@pytest.mark.parametrize("problem", ["logistic", "svm"])
def test_run_matches_jax(classif, problem, backend):
    D, lab = classif
    js, ts, iters = _solvers(problem, backend)
    rj = js.run(jnp.asarray(D), jnp.asarray(lab), iters=iters)
    rt = ts.run(torch.from_numpy(D), torch.from_numpy(lab), iters=iters)
    assert _rel(rt.x, rj.x) < 2e-4
    oj = np.asarray(rj.history.objective)
    assert np.max(np.abs(rt.history.objective.numpy() - oj)
                  / np.abs(oj)) < 1e-4
    np.testing.assert_allclose(rt.history.primal_res.numpy(),
                               np.asarray(rj.history.primal_res), atol=1e-3)
    np.testing.assert_allclose(rt.history.dual_res.numpy(),
                               np.asarray(rj.history.dual_res),
                               rtol=1e-3, atol=1e-3)
    if problem == "logistic":
        np.testing.assert_allclose(rt.history.grad_sq.numpy(),
                                   np.asarray(rj.history.grad_sq),
                                   rtol=1e-3, atol=1e-4)
    # DESIGN.md section 3: the stop iteration may differ by a few
    assert abs(rt.history.converged_at - int(rj.history.converged_at)) <= 3
    assert abs(rt.iters - int(rj.iters)) <= 3
    assert tuple(rt.y.shape) == (4, 250) and tuple(rt.lam.shape) == (4, 250)


@pytest.mark.parametrize("backend", ["chunked", "cuda"])
@pytest.mark.parametrize("problem", ["logistic", "svm"])
def test_solve_matches_jax(classif, problem, backend):
    D, lab = classif
    js, ts, _ = _solvers(problem, backend)
    rj = js.solve(jnp.asarray(D), jnp.asarray(lab), max_iters=400,
                  record=True)
    rt = ts.solve(torch.from_numpy(D), torch.from_numpy(lab), max_iters=400,
                  record=True)
    assert abs(rt.iters - int(rj.iters)) <= 3
    k = min(rt.iters, int(rj.iters))
    if rt.iters == int(rj.iters):
        assert _rel(rt.x, rj.x) < 2e-4
    oj = np.asarray(rj.history.objective)[:k]
    assert np.max(np.abs(rt.history.objective.numpy()[:k] - oj)
                  / np.abs(oj)) < 1e-4
    np.testing.assert_allclose(rt.history.primal_res.numpy()[:k],
                               np.asarray(rj.history.primal_res)[:k],
                               atol=1e-3)


def test_run_bf16_residency_matches_jax(classif):
    D, lab = classif
    rj = JADMM(loss=jprox.make_logistic(), tau=0.1,
               backend="reference").run(jnp.asarray(D), jnp.asarray(lab),
                                        iters=60)
    for backend in ("chunked", "cuda"):
        rt = UnwrappedADMM(tprox.make_logistic(), tau=0.1, backend=backend,
                           residency="bf16", device="cpu").run(
            torch.from_numpy(D), torch.from_numpy(lab), iters=60)
        assert _rel(rt.x, rj.x) < 5e-3


def test_solve_honors_warm_start(classif):
    """tests/test_engine.py:247 on the port, and the warm-started x
    agrees with the JAX package's."""
    D, lab = classif
    Dt, lt = torch.from_numpy(D), torch.from_numpy(lab)
    solver = UnwrappedADMM(tprox.make_logistic(), tau=0.1, device="cpu")
    cold = solver.solve(Dt, lt, max_iters=300)
    warm = solver.solve(Dt, lt, max_iters=300, x0=cold.x)
    assert warm.iters < 300
    assert _rel(warm.x, cold.x) < 5e-3
    w1 = solver.run(Dt, lt, iters=1, x0=cold.x)
    c1 = solver.run(Dt, lt, iters=1)
    assert float(torch.linalg.norm(w1.x - c1.x)) > 1e-3
    js = JADMM(loss=jprox.make_logistic(), tau=0.1, backend="chunked")
    jw = js.run(jnp.asarray(D), jnp.asarray(lab), iters=5,
                x0=jnp.asarray(cold.x.numpy()))
    tw = solver.run(Dt, lt, iters=5, x0=cold.x)
    assert _rel(tw.x, jw.x) < 2e-4


@pytest.mark.parametrize("problem", ["logistic", "svm"])
@pytest.mark.parametrize("source", ["result", "checkpoint_tree"])
def test_carry_jax_state_across(classif, problem, source):
    """Run the JAX package for k iterations, carry its state into the port
    with convert.py, take one more iteration in both, and compare."""
    D, lab = classif
    kw, jl, tl, _ = PROBLEMS[problem]
    js = JADMM(loss=jl(), backend="chunked", **kw)
    res = js.run(jnp.asarray(D), jnp.asarray(lab), iters=15)
    src = res if source == "result" else {
        "x": np.asarray(res.x), "y": np.asarray(res.y),
        "lam": np.asarray(res.lam), "d": np.zeros(20, np.float32)}
    st = convert.solver_state(src, device="cpu")
    Dt, lt = convert.problem_data(D, lab, device="cpu")
    loss = convert.loss_from_spec({"name": "hinge", "C": 1.0}
                                  if problem == "svm"
                                  else {"name": "logistic"})
    ts = UnwrappedADMM(loss=loss, device="cpu", **kw)
    Lj = js.setup(jnp.asarray(D))
    Lt = ts.setup(Dt)
    out_j = js.step(Lj, jnp.asarray(D), jnp.asarray(lab), res.y, res.lam)
    out_t = ts.step(Lt, Dt, lt, st["y"], st["lam"])
    for got, want in zip(out_t, out_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=3e-5)
    if source == "result":
        assert st["d"] is None
        np.testing.assert_array_equal(st["x"].numpy(), np.asarray(res.x))


def test_composite_l1_x_update_matches_jax():
    """solve(reg=make_l1_reg(mu)) — the lasso through the composite
    prox-gradient x-update — against the JAX driver."""
    p = j_lasso(jax.random.PRNGKey(1), N=2, m_per_node=200, n=24)
    D, b, mu = np.array(p.D), np.array(p.b), float(p.mu)
    rj = JADMM(loss=jprox.make_least_squares(), tau=1.0,
               backend="chunked").solve(jnp.asarray(D), jnp.asarray(b),
                                        max_iters=200, reg=j_l1_reg(mu),
                                        record=True)
    rt = UnwrappedADMM(tprox.make_least_squares(), tau=1.0,
                       device="cpu").solve(torch.from_numpy(D),
                                           torch.from_numpy(b),
                                           max_iters=200,
                                           reg=make_l1_reg(mu), record=True)
    assert abs(rt.iters - int(rj.iters)) <= 3
    assert _rel(rt.x, rj.x) < 1e-3
    k = min(rt.iters, int(rj.iters))
    np.testing.assert_allclose(rt.history.objective.numpy()[:k],
                               np.asarray(rj.history.objective)[:k],
                               rtol=1e-4)


def test_unported_paths_name_their_roadmap_item(classif):
    D, lab = classif
    Dt, lt = torch.from_numpy(D), torch.from_numpy(lab)
    s = UnwrappedADMM(tprox.make_logistic(), tau=0.1, device="cpu")
    # observability (the obs copy of ROADMAP item 10) is ported: a
    # disabled bundle is the obs-off path, bit for bit
    from repro_torch.obs import NOOP
    assert torch.equal(s.solve(Dt, lt, max_iters=8, obs=NOOP).x,
                       s.solve(Dt, lt, max_iters=8).x)
    # checkpoints and the out-of-core solve (ROADMAP item 7) are ported:
    # a checkpointed solve resumes to the same bits as an uninterrupted one
    import tempfile
    from repro_torch.data.store import ShardedMatrixStore
    with tempfile.TemporaryDirectory() as tmp:
        full = s.solve(Dt, lt, max_iters=12)
        s.solve(Dt, lt, max_iters=5, checkpoint_dir=tmp,
                checkpoint_every=5)
        back = s.solve(Dt, lt, max_iters=12, checkpoint_dir=tmp,
                       resume=True)
        assert back.iters == full.iters and torch.equal(back.x, full.x)
    store = ShardedMatrixStore.from_arrays(D, lab, block_rows=300)
    st = s.solve_streaming(store, max_iters=12)
    assert float(torch.linalg.norm(st.x - full.x)
                 / torch.linalg.norm(full.x)) < 2e-4
    # sparse data (ROADMAP item 6) are ported: a BlockCSR of the same
    # matrix solves to the dense solve's x, y / lam as (1, m)
    from repro_torch.data.sparse import BlockCSR
    B = BlockCSR.from_dense(Dt, block_m=256)
    rs, rd = s.solve(B, lt.reshape(-1)), s.solve(Dt, lt)
    assert rs.y.shape == (1, Dt.shape[0] * Dt.shape[1])
    assert abs(rs.iters - rd.iters) <= 5
    assert _rel(rs.x, rd.x) < 1e-4


def test_history_shapes_and_final_x(classif):
    D, lab = classif
    Dt, lt = torch.from_numpy(D), torch.from_numpy(lab)
    s = UnwrappedADMM(tprox.make_logistic(), tau=0.1, device="cpu")
    res = s.run(Dt, lt, iters=40)
    assert res.x.shape == (20,)
    for field in ("objective", "primal_res", "dual_res", "grad_sq"):
        assert getattr(res.history, field).shape == (40,)
    Dx = torch.einsum("imn,n->im", Dt, res.x).reshape(-1)
    obj = float(s._objective(res.x, Dx, lt.reshape(-1)))
    assert abs(obj - float(res.history.objective[-1])) < 1e-3 * abs(obj)
    assert s.run(Dt, lt, iters=5, record=False).history is None
    assert flat_to_nodes(Dt.reshape(1000, 20), 4).shape == (4, 250, 20)
    with pytest.raises(ValueError):
        flat_to_nodes(Dt.reshape(1000, 20), 3)


def test_star_catalog_problem_is_full_rank():
    """307 features of the paper's width; unlike the reference's grid of
    one set of measurements with itself, the products are distinct, so the
    Gram is positive definite and the logistic solve is well posed."""
    p = synthetic.star_catalog_problem(3, 2, 1500, device="cpu")
    assert tuple(p.D.shape) == (2, 1500, 307)
    assert bool(torch.isfinite(p.D).all())
    assert set(torch.unique(p.labels).tolist()) <= {-1.0, 1.0}
    D = p.D.reshape(-1, 307).double()
    assert torch.equal(D[:, -1], torch.ones(3000, dtype=torch.float64))
    assert torch.linalg.matrix_rank(D).item() == 307
    torch.linalg.cholesky(D.T @ D)
    again = synthetic.star_catalog_problem(3, 2, 1500, device="cpu")
    assert torch.equal(p.D, again.D) and torch.equal(p.labels, again.labels)


def test_reference_star_catalog_is_singular():
    """The fault the port's generator fixes (ROADMAP section 3): the JAX
    generator's product grid repeats columns, so its Gram is singular,
    its Cholesky factor is NaN, and its bias column is scaled to 1e6."""
    from repro.core.gram import gram_factor
    from repro.data.synthetic import star_catalog_problem
    p = star_catalog_problem(jax.random.PRNGKey(2), N=1, m_per_node=4000)
    D = np.asarray(p.D, np.float64).reshape(-1, 307)
    assert np.linalg.matrix_rank(D) < 307
    np.testing.assert_array_equal(D[:, 17 + 1], D[:, 17 + 17])  # (0,1)=(1,0)
    np.testing.assert_allclose(D[:, -1], 1e6)
    G = jnp.asarray(D.T @ D, jnp.float32)
    assert not bool(jnp.isfinite(gram_factor(G)).all())


def test_classification_problem_layout():
    p = synthetic.classification_problem(0, 3, 101, 12, heterogeneity=1.0,
                                         device="cpu")
    assert tuple(p.D.shape) == (3, 101, 12)
    assert (p.labels > 0).sum(1).tolist() == [50, 50, 50]
    pos = p.labels.reshape(-1) > 0
    shift = p.D.reshape(-1, 12)[pos, :5].mean() - \
        p.D.reshape(-1, 12)[~pos, :5].mean()
    assert 0.6 < float(shift) < 1.4           # the informative mean shift


def test_convert_bf16_and_devices():
    import ml_dtypes
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = convert.tensor(a.astype(ml_dtypes.bfloat16), device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a)
    D, aux = convert.problem_data(a[None], None, device="cpu")
    assert D.dtype == torch.float32 and aux is None


def test_fit_cli_cpu(capsys):
    res = fit_cli.main(["--device", "cpu", "--nodes", "2",
                        "--rows-per-node", "500", "--features", "10",
                        "--iters", "100"])
    out = capsys.readouterr().out
    assert "[transpose] logistic:" in out and "train acc:" in out
    assert bool(torch.isfinite(res.x).all())
    fit_cli.main(["--device", "cpu", "--problem", "svm", "--nodes", "1",
                  "--rows-per-node", "400", "--features", "8",
                  "--iters", "50"])
    assert "objective:" in capsys.readouterr().out


@pytest.mark.parametrize("argv,item", [
    (["--workers", "2"], "ROADMAP item 9"),
    (["--executor", "cluster"], "ROADMAP item 9"),
    (["--obs-dir", "obs"], "ROADMAP item 10"),
])
def test_fit_cli_names_roadmap_item_for_unported_flags(argv, item,
                                                       tmp_path, capsys):
    """The flags of the cluster runtime (item 9) and the obs copy (item
    10) were refused until those items were ported; now each one runs. A
    lone ``--workers`` keeps the local executor, as in the JAX CLI."""
    if argv[0] == "--obs-dir":
        argv = ["--obs-dir", str(tmp_path / "obs")]
    res = fit_cli.main(["--device", "cpu", "--nodes", "2",
                        "--rows-per-node", "200", "--features", "8",
                        "--iters", "20"] + argv)
    out = capsys.readouterr().out
    assert bool(torch.isfinite(torch.as_tensor(res.x)).all())
    assert ("cluster: 2/2 workers alive" in out) == \
        (argv == ["--executor", "cluster"])
    if argv[0] == "--obs-dir":
        assert "obs: wrote" in out
        assert (tmp_path / "obs" / "trace.json").exists()


@pytest.mark.parametrize("argv,ranks", [
    (["--executor", "shard_map"], 2),     # two gloo ranks, spawned
    (["--multi-device"], 1),              # the deprecated alias: SOLO
])
def test_fit_cli_shard_map_cpu(argv, ranks, capsys, monkeypatch):
    """The shard_map path of the CLI (ROADMAP item 8) fits on the CPU: as
    many gloo ranks as REPRO_TORCH_CPU_RANKS says, the same x as the
    local executor's to the parity tolerance (the stop iteration may
    differ by a few: the residuals near the stop are at rounding level,
    and the ranks sum in another order)."""
    monkeypatch.setenv("REPRO_TORCH_CPU_RANKS", str(ranks))
    base = ["--device", "cpu", "--nodes", "2", "--rows-per-node", "300",
            "--features", "10", "--iters", "100"]
    if argv == ["--multi-device"]:
        with pytest.warns(DeprecationWarning, match="--multi-device"):
            res = fit_cli.main(base + argv)
    else:
        res = fit_cli.main(base + argv)
    out = capsys.readouterr().out
    backend = "gloo" if ranks > 1 else "none"     # a world of one: SOLO
    assert f"shard_map: {ranks} ranks on {backend}" in out \
        and "train acc:" in out
    ref = fit_cli.main(base)
    gap = float((res.x - ref.x).abs().max()) / max(1.0, float(
        ref.x.abs().max()))
    assert gap <= 1e-5, gap


def test_world_of_one_executor_leaves_no_group(capsys, monkeypatch):
    """A shard_map executor built outside any group (a world of one) starts
    no process group, so a later CLI fit in the same process still spawns
    the ranks REPRO_TORCH_CPU_RANKS asks for."""
    from repro_torch.exec import problems as tprob
    prob = tprob.make_problem("logistic")
    D, aux = tprob.synth_data(prob, m=60, n=5, seed=1)
    ex = tprob.make_executor("shard_map", prob, D, aux, device="cpu")
    assert ex.world == 1 and not torch.distributed.is_initialized()
    monkeypatch.setenv("REPRO_TORCH_CPU_RANKS", "2")
    fit_cli.main(["--device", "cpu", "--nodes", "2", "--rows-per-node",
                  "100", "--features", "6", "--iters", "20",
                  "--executor", "shard_map"])
    assert "shard_map: 2 ranks on gloo" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()
