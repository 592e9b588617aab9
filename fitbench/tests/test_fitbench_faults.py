"""``correct`` at a size a test run holds, on the CPU: true for the
program as it is; false for the control (the program with its bf16 path
switched on) and for the program broken underneath the timed path, once
for each fault a cell can have: a step that returns its state unchanged,
half of the rows left out with the sums scaled up from the rest, the
exchange between the ranks left out, and the answer altered where it is
produced. The chip check is skipped: ``run_cell`` is driven directly."""

import pytest
import torch

from fitbench import harness, manifest, ranks

BENCH = manifest.load()
SMALL = {"star-logistic": {"rows_per_node": 20000},
         "star-logistic-x4": {"rows_per_node": 5000}}


def fault_state_unchanged(mp):
    from repro_torch.exec import local
    real = local.fused_step

    def step(engine, D, aux, y, lam, x):
        _, _, sw = real(engine, D, aux, y, lam, x)
        return y, lam, sw
    mp.setattr(local, "fused_step", step)


def fault_half_rows(mp):
    from repro_torch.exec import local
    real = local.fused_step

    def step(engine, D, aux, y, lam, x):
        h = D.shape[0] // 2
        yh, lh, sw = real(engine, D[:h], aux[:h], y[:h], lam[:h], x)
        sw = sw._replace(d=2 * sw.d, w=2 * sw.w, v=2 * sw.v)
        return (torch.cat([yh, y[h:]]), torch.cat([lh, lam[h:]]), sw)
    mp.setattr(local, "fused_step", step)


def fault_no_exchange(mp):
    from repro_torch.exec import shard_map
    mp.setattr(shard_map, "ordered_allreduce",
               lambda t, group: t * group.world)


def fault_answer_altered(mp):
    from repro_torch import exec as exec_pkg
    from repro_torch.exec import base
    real = base.solve_with_executor

    def solve(ex, **kw):
        res = real(ex, **kw)
        return res._replace(x=res.x * (1 + 1e-3))
    mp.setattr(base, "solve_with_executor", solve)
    mp.setattr(exec_pkg, "solve_with_executor", solve)


FAULTS = {"state_unchanged": fault_state_unchanged,
          "half_rows": fault_half_rows,
          "no_exchange": fault_no_exchange,
          "answer_altered": fault_answer_altered}


def _one_rank(cell, override, fault):
    mp = pytest.MonkeyPatch()
    if fault:
        FAULTS[fault](mp)
    try:
        return harness.run_cell(cell, 2 ** 31 + 11, 0.001, False,
                                device="cpu", bench=BENCH,
                                cfg_override=override)
    finally:
        mp.undo()


def _rank(fault, w, seed, seconds, trace, device, t0, rank):
    mp = pytest.MonkeyPatch()
    if fault:
        FAULTS[fault](mp)
    torch.set_num_threads(1)
    try:
        return harness._rank(w, seed, seconds, trace, device, t0, rank=rank)
    finally:
        mp.undo()


def _four_ranks(cell, override, fault, monkeypatch):
    # the same thread count on every rank: the CPU's reductions then
    # give every rank the same bits, as the card's fixed orders do
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    w = manifest.cell(BENCH, cell)
    w["cfg"].update(override)
    return ranks.run(4, _rank, (fault, w, 2 ** 31 + 11, 0.001, False, "cpu",
                                0.0))


def run(cell, fault=None, override=None, monkeypatch=None):
    override = {**SMALL[cell], **(override or {})}
    if manifest.cell(BENCH, cell)["chips"] == 1:
        return _one_rank(cell, override, fault)
    return _four_ranks(cell, override, fault, monkeypatch)


@pytest.mark.parametrize("cell", list(SMALL))
def test_sound_run_is_correct(cell, monkeypatch):
    out = run(cell, monkeypatch=monkeypatch)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_is_not_correct(cell, monkeypatch):
    out = run(cell, override={"residency": "bf16"}, monkeypatch=monkeypatch)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell,fault", [
    ("star-logistic", "state_unchanged"), ("star-logistic", "half_rows"),
    ("star-logistic", "answer_altered"), ("star-logistic-x4", "no_exchange"),
    ("star-logistic-x4", "answer_altered")])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    out = run(cell, fault=fault, monkeypatch=monkeypatch)
    assert not out["correct"], out["checks"]
    assert out["failed"] == out["attempted"]


@pytest.mark.cuda
def test_control_on_the_card_is_not_correct():
    """The control at the star catalog's small shape on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = harness.run_cell("star-logistic", 2 ** 31 + 13, 0.001, False,
                           device="cuda",
                           cfg_override={**SMALL["star-logistic"],
                                         "residency": "bf16"})
    assert not out["correct"], out["checks"]
