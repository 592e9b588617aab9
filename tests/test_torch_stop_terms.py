"""The stopping rule's four sums (r_sq, dx_sq, y_sq, obj): taken from the
fused body where it emits them (``EngineStep.stats``, K3 and its plain
version), else formed by torch passes over the m-vectors. Both give the
same totals in ``exec/local.py::fused_step`` and in the streaming block
step, each sweep counts one ``stop_terms.fused`` or ``stop_terms.torch``,
and a whole solve on the ``cuda`` backend follows the ``chunked`` one.
On a CPU tensor the ``cuda`` backend runs K3's plain version."""
import numpy as np
import pytest
import torch

from repro_torch.core import prox
from repro_torch.core.unwrapped import UnwrappedADMM
from repro_torch.engine import IterationEngine
from repro_torch.engine.engine import EngineStep
from repro_torch.engine.streaming import _block_fns, _zero_sweep
from repro_torch.exec.local import fused_step
from repro_torch.obs import Observability, recording

torch.set_num_threads(1)

KINDS = {"logistic": prox.make_logistic(), "hinge": prox.make_hinge(0.7),
         "l1": prox.make_l1(0.3),
         "least_squares": prox.make_least_squares(),
         "quantile": prox.make_quantile(0.3)}
SCALARS = ("r_sq", "dx_sq", "y_sq", "obj")


def _state(m, n, seed=0, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    D = torch.randn((m, n), generator=g, device=device)
    aux = torch.sign(torch.randn(m, generator=g, device=device))
    y, lam = (torch.randn(m, generator=g, device=device) for _ in range(2))
    x = 0.1 * torch.randn(n, generator=g, device=device)
    return D, aux, y, lam, x


def _counts(ob):
    return (ob.registry.counter_value("stop_terms.fused"),
            ob.registry.counter_value("stop_terms.torch"))


class _Engine:
    """An engine whose fused body returns a fixed step."""

    def __init__(self, step, loss):
        self.step, self.loss = step, loss

    def iterate(self, D, aux, y, lam, x, want_dual=True):
        return self.step


def _refusing_loss():
    def value(z, aux):
        raise AssertionError("the torch passes ran")
    return prox.ProxLoss("logistic", value, prox.make_logistic().prox)


def test_fused_step_takes_the_body_sums():
    m, n = 64, 5
    _, _, y, lam, _ = _state(m, n)
    stats = torch.tensor([1.0, 2.0, 3.0, 4.0])
    st = EngineStep(y + 1, lam + 1, torch.ones(n), torch.ones(n),
                    torch.ones(n), stats)
    ob = Observability(enabled=True)
    with recording(ob):
        y2, lam2, sw = fused_step(_Engine(st, _refusing_loss()), None, None,
                                  y, lam, None)
    assert y2 is st.y and lam2 is st.lam
    assert [float(getattr(sw, k)) for k in SCALARS] == [1.0, 2.0, 3.0, 4.0]
    assert _counts(ob) == (1, 0)


def test_fused_step_without_stats_runs_the_torch_passes():
    m, n = 64, 5
    _, aux, y, lam, _ = _state(m, n)
    yn, ln = y + 0.5, lam - 0.25
    st = EngineStep(yn, ln, torch.ones(n), torch.ones(n), torch.ones(n))
    assert st.stats is None
    loss = prox.make_logistic()
    ob = Observability(enabled=True)
    with recording(ob):
        _, _, sw = fused_step(_Engine(st, loss), None, aux, y, lam, None)
    Dx = ln - lam + yn
    want = [torch.sum((ln - lam) ** 2), torch.sum(Dx * Dx),
            torch.sum(yn * yn), loss.value(Dx, aux)]
    assert all(torch.equal(getattr(sw, k), w) for k, w in zip(SCALARS, want))
    assert _counts(ob) == (0, 1)


@pytest.mark.parametrize("kind", list(KINDS))
def test_fused_step_body_sums_match_torch_passes(kind):
    """A real step on each path: the ``cuda`` body (K3's plain version
    here) emits the sums, the ``chunked`` body does not; the SweepResults
    agree."""
    D, aux, y, lam, x = _state(3000, 40, seed=1)
    a = None if kind == "l1" else aux
    got = {}
    for backend in ("cuda", "chunked"):
        eng = IterationEngine(loss=KINDS[kind], tau=0.5, backend=backend,
                              device="cpu")
        ob = Observability(enabled=True)
        with recording(ob):
            got[backend] = fused_step(eng, D, a, y, lam, x)[2]
        assert _counts(ob) == ((1, 0) if backend == "cuda" else (0, 1))
    for k in SCALARS:
        np.testing.assert_allclose(float(getattr(got["cuda"], k)),
                                   float(getattr(got["chunked"], k)),
                                   rtol=1e-5)


@pytest.mark.parametrize("kind", list(KINDS))
def test_block_step_accumulates_the_same_totals(kind):
    """The streaming body's accumulators over three blocks, from the
    body's sums or from the torch passes."""
    D, aux, y, lam, x = _state(2500, 24, seed=2)
    blocks = [(0, 1000), (1000, 2000), (2000, 2500)]
    has_aux = kind != "l1"
    acc = {}
    for backend in ("cuda", "chunked"):
        eng = IterationEngine(loss=KINDS[kind], tau=0.5, backend=backend,
                              device="cpu")
        step, _, _ = _block_fns(eng, has_aux)
        tot = _zero_sweep(24, torch.float32)
        for s, e in blocks:
            _, _, tot = step(D[s:e], aux[s:e], y[s:e], lam[s:e], x, tot)
        acc[backend] = tot
    for k in SCALARS:
        np.testing.assert_allclose(float(getattr(acc["cuda"], k)),
                                   float(getattr(acc["chunked"], k)),
                                   rtol=1e-5)
    for k in ("d", "w", "v"):
        np.testing.assert_allclose(getattr(acc["cuda"], k).numpy(),
                                   getattr(acc["chunked"], k).numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("path", ["cuda", "chunked", "sparse"])
def test_stop_terms_counted_once_per_sweep(path):
    """One ``stop_terms.fused`` a sweep on the body that emits the sums,
    one ``stop_terms.torch`` on the chunked and sparse bodies."""
    from repro_torch.data.sparse import BlockCSR
    D, aux, _, _, _ = _state(800, 12, seed=3)
    if path == "sparse":
        D = D * (torch.rand(D.shape, generator=torch.Generator()
                            .manual_seed(4)) < 0.2)
        data, labels = BlockCSR.from_dense(D.numpy(), block_m=128,
                                           device="cpu"), aux
    else:
        data, labels = D.reshape(2, 400, 12), aux.reshape(2, 400)
    solver = UnwrappedADMM(loss=prox.make_logistic(), tau=1.0, eps_rel=0.0,
                           eps_abs=0.0, device="cpu",
                           backend="auto" if path == "sparse" else path)
    ob = Observability(enabled=True)
    with recording(ob):
        res = solver.solve(data, labels, max_iters=7)
    assert res.iters == 7
    assert _counts(ob) == ((7, 0) if path == "cuda" else (0, 7))


def _solve(device, backend):
    """The logistic fit with a ridge (rho 1) on 4 nodes of 1000 x 32 rows,
    stopped by Boyd's rule (eps_rel 0.1) after a few dozen iterations,
    while r and s lie far above their f32 rounding floor; the data made
    on the host, so every device solves the same problem."""
    g = torch.Generator().manual_seed(5)
    D = torch.randn((4000, 32), generator=g)
    w = torch.randn(32, generator=g)
    labels = torch.sign(D @ w + 3.0 * torch.randn(4000, generator=g))
    solver = UnwrappedADMM(loss=prox.make_logistic(), tau=0.01, rho=1.0,
                           eps_rel=0.1, backend=backend, device=device)
    return solver.solve(D.reshape(4, 1000, 32).to(device),
                        labels.reshape(4, 1000).to(device), max_iters=200,
                        record=True)


def _assert_same_history(a, b, rtol, s_rtol=None):
    """The same iterations; r, s and the objective within ``rtol`` at
    every iteration, s within ``s_rtol`` where given."""
    assert a.history.converged_at >= 0
    assert a.iters == b.iters
    for name, tol in (("primal_res", rtol), ("dual_res", s_rtol or rtol),
                      ("objective", rtol)):
        np.testing.assert_allclose(getattr(a.history, name).cpu().numpy(),
                                   getattr(b.history, name).cpu().numpy(),
                                   rtol=tol, err_msg=name)


def _drop_stats(monkeypatch):
    """The cuda body with its sums dropped: fused_step's torch passes run
    on the same iterates."""
    real = IterationEngine._iterate_cuda

    def body(self, *args):
        return real(self, *args)._replace(stats=None)
    monkeypatch.setattr(IterationEngine, "_iterate_cuda", body)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")


# s = tau ||w||, w = D^T (y' - y) summed by each body in its own order: not
# one of the four sums, and between the two bodies' f32 orders it reads
# 1.2e-4 apart on this solve on the CPU (a sum with cancellation), so it is
# held to 1e-3 there; the same iterates (below) give it to 1e-5.
S_RTOL = 1e-3


def test_solve_fused_sums_follow_chunked():
    """A LocalExecutor solve on the ``cuda`` backend (K3's plain version on
    the CPU) against the ``chunked`` backend: the same iterations, and r
    and the objective within 1e-4 relative at every iteration."""
    _assert_same_history(_solve("cpu", "cuda"), _solve("cpu", "chunked"),
                         1e-4, S_RTOL)


def test_solve_fused_sums_follow_torch_passes(monkeypatch):
    """The same solve on the same iterates, Boyd's rule and the history
    read from the body's sums and from the torch passes."""
    fused = _solve("cpu", "cuda")
    _drop_stats(monkeypatch)
    _assert_same_history(fused, _solve("cpu", "cuda"), 1e-5)


@pytest.mark.cuda
def test_solve_fused_sums_follow_chunked_on_card():
    """As above with K3 itself on the card, one launch an iteration: its
    four sums drive Boyd's rule and the recorded history."""
    _card()
    from repro_torch.kernels.admm_iter import ops
    before = ops.admm_iter_full.launches
    fused = _solve("cuda", "cuda")
    assert ops.admm_iter_full.launches - before == fused.iters
    _assert_same_history(fused, _solve("cuda", "chunked"), 1e-4, S_RTOL)


@pytest.mark.cuda
def test_solve_fused_sums_follow_torch_passes_on_card(monkeypatch):
    _card()
    fused = _solve("cuda", "cuda")
    _drop_stats(monkeypatch)
    _assert_same_history(fused, _solve("cuda", "cuda"), 1e-5)
