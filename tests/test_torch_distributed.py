"""Port parity for ``repro_torch.core.distributed`` (and the process-group
helpers of ``repro_torch.sharding.compat``): the mirrors of
``tests/test_distributed.py``'s four ADMM tests, run on gloo ranks on the
CPU against the JAX package.

In this process JAX has one CPU device, so the port's solve at world 2, 4
and 8 is held to the JAX single-device ``UnwrappedADMM.run``, which the
reference's own tests hold equal to its 8-shard shard_map at 1e-5; one
subprocess with eight virtual devices compares the port with the JAX
8-device ``DistributedUnwrappedADMM`` directly. The ranks of each world
size are spawned once for the module and run every case
(``core.distributed.solve_rank``). ``test_moe_a2a_matches_dense_reference``
and the production-mesh dry-run belong to the LM stack (ROADMAP item 11)."""
import json
import operator
import os
import subprocess
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platform_name", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core.oracles import logistic_objective  # noqa: E402
from repro.core.prox import StackedProx, make_l1, make_logistic  # noqa: E402
from repro.core.unwrapped import UnwrappedADMM  # noqa: E402
from repro.data.synthetic import classification_problem  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.distributed import solve_rank  # noqa: E402
from repro_torch.sharding import compat  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (2, 4, 8)
SPAWN_TIMEOUT = 300
MU = 5.0
LOGISTIC = {"name": "logistic"}


def _flat(prob, n=20):
    return (np.asarray(prob.D).reshape(-1, n),
            np.asarray(prob.labels).reshape(-1))


@pytest.fixture(scope="module")
def data():
    """The reference tests' problems: 8 nodes x 125 rows x 20 (PRNGKey 0),
    and the uneven 997 rows (PRNGKey 1)."""
    even = classification_problem(jax.random.PRNGKey(0), N=8,
                                  m_per_node=125, n=20)
    uneven = classification_problem(jax.random.PRNGKey(1), N=1,
                                    m_per_node=997, n=20)
    return {"even": even, "uneven": uneven}


CASES = {
    # name -> (problem, solver fields, iterations, worlds)
    "plain": ("even", {}, 80, WORLDS),
    "uneven": ("uneven", {}, 60, WORLDS),
    "compressed": ("even", {"compress": True}, 100, (8,)),
    "l1": ("even", {"l1_mu": MU}, 300, (8,)),
}


@pytest.fixture(scope="module")
def runs(data):
    """world -> case -> the ranks' results (each rank's x and histories)."""
    out = {}
    for world in WORLDS:
        names = [k for k, c in CASES.items() if world in c[3]]
        calls = []
        for name in names:
            prob, fields, iters, _ = CASES[name]
            D, aux = _flat(data[prob])
            calls.append(dict(loss=LOGISTIC, D=D, aux=aux, iters=iters,
                              tau=0.1, **fields))
        ranks = compat.spawn(solve_rank, world, "gloo",
                             args=(calls, "cpu"), device="cpu", threads=1,
                             timeout=SPAWN_TIMEOUT)
        out[world] = {name: [r[i] for r in ranks]
                      for i, name in enumerate(names)}
    return out


def _jax_run(prob, iters, **kw):
    return UnwrappedADMM(loss=make_logistic(), tau=0.1, **kw).run(
        prob.D, prob.labels, iters=iters)


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_equals_single_device(world, data, runs):
    ref = _jax_run(data["even"], 80)
    r = runs[world]["plain"][0]
    x_ref = np.asarray(ref.x)
    err = np.linalg.norm(r["x"] - x_ref) / np.linalg.norm(x_ref)
    obj_ref = np.asarray(ref.history.objective)
    hist_gap = np.max(np.abs(r["objective"] - obj_ref) / np.abs(obj_ref))
    res_gap = np.max(np.abs(r["primal_res"]
                            - np.asarray(ref.history.primal_res)))
    assert err < 1e-5, err
    assert hist_gap < 1e-4, hist_gap
    assert res_gap < 1e-3, res_gap


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_uneven_rows_zero_padded(world, data, runs):
    """997 rows: the last rank's shard is zero-padded (exact under the
    transpose reduction) and the objective history drops the pad rows'
    constant f(0) term."""
    assert 997 % world != 0
    ref = _jax_run(data["uneven"], 60)
    r = runs[world]["uneven"][0]
    x_ref = np.asarray(ref.x)
    err = np.linalg.norm(r["x"] - x_ref) / np.linalg.norm(x_ref)
    obj_ref = np.asarray(ref.history.objective)
    hist_gap = np.max(np.abs(r["objective"] - obj_ref) / np.abs(obj_ref))
    assert err < 1e-5, err
    assert hist_gap < 1e-4, hist_gap


def test_compressed_reduction_converges(data, runs):
    ref = _jax_run(data["even"], 100)
    obj = float(runs[8]["compressed"][0]["objective"][-1])
    ref_obj = float(ref.history.objective[-1])
    assert abs(obj - ref_obj) / abs(ref_obj) < 1e-3


def test_composite_l1_xupdate_matches_stacked(data, runs):
    D, lab = _flat(data["even"])
    x = runs[8]["l1"][0]["x"]
    D_hat = jnp.concatenate([jnp.eye(20), jnp.asarray(D)], axis=0)[None]
    sp = StackedProx(blocks=(make_l1(MU), make_logistic()),
                     sizes=(20, D.shape[0]))
    aux = jnp.concatenate([jnp.zeros(20), jnp.asarray(lab)])[None]
    res = UnwrappedADMM(loss=sp.as_loss(), tau=0.1).run(D_hat, aux,
                                                         iters=1500)
    o1 = logistic_objective(D, lab, x) + MU * float(np.abs(x).sum())
    xr = np.asarray(res.x)
    o2 = logistic_objective(D, lab, xr) + MU * float(np.abs(xr).sum())
    assert abs(o1 - o2) / abs(o2) < 2e-3


def test_x_and_histories_bitwise_equal_on_every_rank(runs):
    for world, cases in runs.items():
        for name, ranks in cases.items():
            assert len(ranks) == world
            for r in ranks[1:]:
                for key in ("x", "objective", "primal_res"):
                    assert np.array_equal(r[key].view(np.uint32),
                                          ranks[0][key].view(np.uint32)), \
                        (world, name, key)


def test_matches_jax_eight_device_shard_map(runs):
    """The JAX package's DistributedUnwrappedADMM on eight virtual CPU
    devices (a subprocess, set up as tests/test_distributed.py does)
    against the port at world 8: 80 plain and 100 compressed
    iterations."""
    script = """
import jax, json, numpy as np
from repro.data.synthetic import classification_problem
from repro.core.prox import make_logistic
from repro.core.distributed import DistributedUnwrappedADMM, shard_rows
from repro.sharding import compat
mesh = compat.make_mesh((8,), ("data",))
prob = classification_problem(jax.random.PRNGKey(0), N=8, m_per_node=125, n=20)
D = shard_rows(mesh, prob.D.reshape(-1, 20), ("data",))
a = shard_rows(mesh, prob.labels.reshape(-1), ("data",))
out = {"ndev": len(jax.devices())}
for name, kw, iters in (("plain", {}, 80), ("compressed", {"compress": True}, 100)):
    s = DistributedUnwrappedADMM(loss=make_logistic(), tau=0.1, **kw)
    x, objs, _ = s.build(mesh, 1000, 20, iters=iters)(D, a)
    out[name] = {"x": np.asarray(x).tolist(),
                 "objective": np.asarray(objs).tolist()}
print(json.dumps(out))
"""
    p = subprocess.run(
        [sys.executable, "-c", script], cwd=str(ROOT), capture_output=True,
        text=True, timeout=600,
        env={"PYTHONPATH": "src", "PATH": os.environ.get("PATH", ""),
             "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    assert p.returncode == 0, p.stderr[-3000:]
    ref = json.loads(p.stdout.strip().splitlines()[-1])
    assert ref["ndev"] == 8
    for name, tol in (("plain", 1e-5), ("compressed", 1e-3)):
        x_ref = np.asarray(ref[name]["x"])
        r = runs[8][name][0]
        err = np.linalg.norm(r["x"] - x_ref) / np.linalg.norm(x_ref)
        obj_ref = np.asarray(ref[name]["objective"])
        gap = np.max(np.abs(r["objective"] - obj_ref) / np.abs(obj_ref))
        assert err < tol and gap < tol, (name, err, gap)


def test_port_continues_jax_shard_map_state():
    """The JAX ShardMapExecutor's mid-solve state (sharded y, lam and EF
    error, compressed) carried into the port by ``convert.shard_state``:
    the next sweep from the same x gives the same iterates and
    reductions (d to one quantization step)."""
    from repro.engine import IterationEngine as JEngine
    from repro.exec import ShardMapExecutor as JShardMap
    from repro.exec import solve_with_executor as j_solve
    from repro_torch.core.prox import make_logistic as t_logistic
    from repro_torch.engine import IterationEngine
    from repro_torch.exec import ShardMapExecutor

    prob = classification_problem(jax.random.PRNGKey(3), N=1,
                                  m_per_node=301, n=12)
    D, lab = _flat(prob, 12)
    jex = JShardMap(JEngine(loss=make_logistic(), tau=0.1), D, aux=lab,
                    compress=True)
    res = j_solve(jex, loss=make_logistic(), tau=0.1, max_iters=10,
                  eps_rel=1e-12, eps_abs=1e-15)
    assert res.iters == 10
    state = {"y": np.asarray(jex._y), "lam": np.asarray(jex._lam),
             "err": np.asarray(jex._err)}
    x = np.asarray(res.x)
    jsw = jex.sweep(jnp.asarray(x), 11)

    tex = ShardMapExecutor(IterationEngine(t_logistic(), tau=0.1,
                                           device="cpu"),
                           D, lab, compress=True)
    assert tex.world == 1 and tex.compress
    tex.setup()
    tex.adopt(convert.shard_state(state, jex.m, 0, 1, device="cpu"))
    assert torch.equal(tex._err, torch.tensor(state["err"][0]))
    tsw = tex.sweep(torch.tensor(x), 11)
    for got, want in ((tex._y, jex._y), (tex._lam, jex._lam),
                      (tsw.w, jsw.w), (tsw.v, jsw.v)):
        want = np.asarray(want)[:jex.m]
        np.testing.assert_allclose(got.numpy()[:jex.m], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    d_ref = np.asarray(jsw.d)
    step = np.abs(d_ref).max() / 127
    assert np.max(np.abs(tsw.d.numpy() - d_ref)) <= 1.01 * step
    for a, b in ((tsw.r_sq, jsw.r_sq), (tsw.obj, jsw.obj)):
        assert abs(float(a) - float(b)) <= 1e-5 * max(1.0, abs(float(b)))


# ---------------------------------------------------------------------------
# the process-group helpers
# ---------------------------------------------------------------------------

def test_shard_rows_and_row_shards():
    a = np.arange(14, dtype=np.float32).reshape(7, 2)
    parts = [compat.shard_rows(a, r, 3) for r in range(3)]
    assert [p.shape for p in parts] == [(3, 2)] * 3
    np.testing.assert_array_equal(np.concatenate(parts)[:7], a)
    assert not parts[2][1:].any()                 # the zero padding
    assert np.shares_memory(parts[0], a)          # a view where unpadded
    t = torch.from_numpy(a)
    for r in range(3):
        got = compat.RowShard(r, 3).take(t)
        assert torch.equal(got, torch.from_numpy(parts[r]))
    assert compat.shard_rows(a, 0, 1).shape == (7, 2)
    # more ranks than rows: the last ranks hold padding only
    assert compat.shard_rows(a[:2], 3, 4).tolist() == [[0.0, 0.0]]


def test_backend_and_device_by_layout(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert compat.layout_backend("cpu", 8) == "gloo"
    assert compat.layout_backend("cuda", 4) == "nccl"
    assert compat.layout_backend("cuda", 8) == "gloo"     # ranks share cards
    assert compat.rank_device("cuda", 5) == torch.device("cuda", 1)
    assert compat.rank_device("cuda:2", 5) == torch.device("cuda", 2)
    assert compat.rank_device("cpu", 5) == torch.device("cpu")
    monkeypatch.setenv(compat.CPU_RANKS_ENV, "8")
    assert compat.local_world("cpu") == 8 and compat.local_world("cuda") == 4
    g = compat.Group(world=3, rank=1, backend="gloo")
    with compat.use_group(g):
        assert compat.current_group() is g and compat.axis_size() == 3
    assert compat.current_group() is not g


def test_spawn_reraises_a_rank_failure_and_times_out_a_hang():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        compat.spawn(operator.truediv, 2, "gloo", args=(1, 0),
                     device="cpu", threads=1, timeout=120)
    with pytest.raises(TimeoutError, match="did not finish"):
        compat.spawn(time.sleep, 2, "gloo", args=(600,), device="cpu",
                     threads=1, timeout=5)
    assert time.monotonic() - t0 < 120
    assert compat.spawn(operator.add, 2, "gloo", args=(2, 3), device="cpu",
                        threads=1) == [5, 5]


STAR_ROWS = 8000
STAR_ITERS = 100


def test_compressed_gap_on_star_catalog_matches_reference(tmp_path):
    """int8 error feedback on the star catalog, whose d spans three orders
    of magnitude within a group (its small entries fall below the int8
    step, 1/127 of the group's largest): the JAX package's own compressed
    solve lands further from its plain one than the 1e-3 its tests hold on
    a narrower d, and the port's lands as far (both at world 2, on the
    port's star catalog); the plain solves agree at 1e-5."""
    from repro_torch.data.synthetic import star_catalog_problem
    prob = star_catalog_problem(0, 1, STAR_ROWS, device="cpu")
    D = prob.D.reshape(STAR_ROWS, -1).numpy()
    a = prob.labels.reshape(-1).numpy()
    np.save(tmp_path / "D.npy", D)
    np.save(tmp_path / "a.npy", a)
    calls = [dict(loss=LOGISTIC, D=D, aux=a, iters=STAR_ITERS, tau=0.1,
                  compress=c) for c in (False, True)]
    ranks = compat.spawn(solve_rank, 2, "gloo", args=(calls, "cpu"),
                         device="cpu", threads=1, timeout=SPAWN_TIMEOUT)
    port = [ranks[0][i]["x"] for i in (0, 1)]
    script = f"""
import json, numpy as np
from repro.core.prox import make_logistic
from repro.core.distributed import DistributedUnwrappedADMM, shard_rows
from repro.sharding import compat
mesh = compat.make_mesh((2,), ("data",))
D = np.load({str(tmp_path / "D.npy")!r}); a = np.load({str(tmp_path / "a.npy")!r})
Dg = shard_rows(mesh, D, ("data",)); ag = shard_rows(mesh, a, ("data",))
xs = [np.asarray(DistributedUnwrappedADMM(
          loss=make_logistic(), tau=0.1, compress=c).build(
          mesh, D.shape[0], D.shape[1], iters={STAR_ITERS})(Dg, ag)[0]).tolist()
      for c in (False, True)]
print(json.dumps(xs))
"""
    p = subprocess.run(
        [sys.executable, "-c", script], cwd=str(ROOT), capture_output=True,
        text=True, timeout=600,
        env={"PYTHONPATH": "src", "PATH": os.environ.get("PATH", ""),
             "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=2"})
    assert p.returncode == 0, p.stderr[-3000:]
    ref = [np.asarray(x) for x in
           json.loads(p.stdout.strip().splitlines()[-1])]

    def obj(x):
        return logistic_objective(D, a, x)

    def gap(x, x0):
        return float(np.abs(x - x0).max() / max(1.0, np.abs(x0).max()))

    g_port = abs(obj(port[1]) - obj(port[0])) / obj(port[0])
    g_ref = abs(obj(ref[1]) - obj(ref[0])) / obj(ref[0])
    print(f"star catalog {STAR_ROWS} x 307, world 2, {STAR_ITERS} "
          f"iterations: compressed vs plain objective gap, port "
          f"{g_port:.3e}, JAX {g_ref:.3e}; x gap, port "
          f"{gap(port[1], port[0]):.3e}, JAX {gap(ref[1], ref[0]):.3e}; "
          f"plain x port vs JAX {gap(port[0], ref[0]):.3e}")
    assert gap(port[0], ref[0]) <= 1e-5
    assert g_ref > 1e-3
    assert 0.5 * g_ref <= g_port <= 2.0 * g_ref



def test_compressed_executor_matches_an_in_process_ef_loop():
    """The shard_map executor's compressed solve at world 2 gives the bits
    of a plain loop in this process over the same engine body: each rank's
    d through ``ef_compress`` with the residual that rank carries, the
    dequantized codes summed in rank order. Under int8 error feedback a
    residual that is not carried, or a code or scale gathered from the
    wrong rank, moves x by the compression's noise (~1e-2 here), not by a
    rounding error."""
    from repro_torch.cluster.compress import dequantize_int8, ef_compress
    from repro_torch.core.gram import gram_factor, gram_solve
    from repro_torch.core.prox import make_logistic as t_logistic
    from repro_torch.data.synthetic import star_catalog_problem
    from repro_torch.engine import IterationEngine
    from repro_torch.exec.shard_map import fit_rank
    rows, iters, world = 1000, 30, 2
    prob = star_catalog_problem(0, 1, world * rows, device="cpu")
    D, a = prob.D.reshape(world * rows, -1), prob.labels.reshape(-1)
    call = dict(problem="logistic", D=D.numpy(), aux=a.numpy(),
                max_iters=iters, eps_rel=1e-12, eps_abs=1e-15, compress=True)
    ranks = compat.spawn(fit_rank, world, "gloo", args=([call], "cpu"),
                         device="cpu", threads=1, timeout=SPAWN_TIMEOUT)
    assert ranks[0][0]["iters"] == iters
    eng = IterationEngine(t_logistic(), tau=0.1, device="cpu")
    shards = [(D[r * rows:(r + 1) * rows], a[r * rows:(r + 1) * rows])
              for r in range(world)]
    G = shards[0][0].new_zeros((D.shape[1],) * 2)
    for S, _ in shards:
        G += eng.gram(S)[0]
    L = gram_factor(G, ridge=0.0)
    n = D.shape[1]
    ys = [torch.zeros(rows) for _ in shards]
    lams = [torch.zeros(rows) for _ in shards]
    errs = [torch.zeros(n) for _ in shards]
    d = torch.zeros(n)
    for _ in range(iters):
        x = gram_solve(L, d)
        parts = []
        for r, (S, A) in enumerate(shards):
            st = eng.iterate(S, A, ys[r], lams[r], x, want_dual=True)
            ys[r], lams[r] = st.y, st.lam
            q, scale, errs[r] = ef_compress(st.d, errs[r])
            parts.append(dequantize_int8(q, scale, n))
        d = parts[0].clone()
        for p in parts[1:]:
            d += p
    for r in range(world):
        assert np.array_equal(ranks[r][0]["x"], x.numpy())


def test_make_group_joins_torchruns_group_and_leaves_it(monkeypatch):
    """Under torchrun's environment ``make_group`` joins the default
    process group for the block and destroys it on leaving; without it,
    it yields ``SOLO`` and initializes nothing."""
    import socket
    with compat.make_group(device="cpu") as g:
        assert g is compat.SOLO and not torch.distributed.is_initialized()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(port))):
        monkeypatch.setenv(k, v)
    with compat.make_group(device="cpu") as g:
        assert g == compat.Group(1, 0, "gloo", 0)
        assert compat.current_group() == g
        assert compat.axis_size() == 1
    assert not torch.distributed.is_initialized()
