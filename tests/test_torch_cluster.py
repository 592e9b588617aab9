"""Port parity for the cluster runtime (``repro_torch.cluster``): the
mirror of ``tests/test_cluster.py``. Shared int8-EF compression,
tree-reduce contributions, membership and reassignment plans, store
content verification, streaming and cluster checkpoint/resume, and real
worker processes on the CPU (``device="cpu"``) — including a worker
SIGKILLed mid-solve with block reassignment. Every cluster x is held to
the JAX package's single-process ``UnwrappedADMM`` x at equal iterations,
at the reference's tolerances; one case runs both packages'
``cluster_solve`` on the same saved store.

Each solve has its own limits so none can hang the suite: workers must
register within ``register_timeout_s`` and a worker silent for
``heartbeat_timeout_s`` is declared dead (the reference's values)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exec_fixtures import cluster_problem as _problem
from repro.core.prox import make_logistic as j_make_logistic
from repro.core.unwrapped import UnwrappedADMM as JADMM
from repro_torch.cluster import compress
from repro_torch.cluster.membership import DeadCluster, Membership, WorkerInfo
from repro_torch.cluster.reduction import (
    Contribution,
    TreeTopology,
    decode,
    encode,
)
from repro_torch.core.oracles import logistic_objective
from repro_torch.core.prox import make_logistic
from repro_torch.core.unwrapped import UnwrappedADMM
from repro_torch.data.store import ShardedMatrixStore

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

TAU = 0.1
TINY = dict(eps_rel=1e-9, eps_abs=1e-12)   # fixed-iteration parity runs


@pytest.fixture(scope="module")
def ref40():
    """The JAX package's single-process reference: 40 fixed iterations on
    the module problem (the cluster runs must land on the same x)."""
    D, aux = _problem()
    res = JADMM(loss=j_make_logistic(), tau=TAU).run(D[None], aux[None],
                                                     iters=40)
    return D, aux, np.asarray(res.x)


def _cluster_cfg(**kw):
    from repro_torch.cluster.coordinator import ClusterConfig
    kw.setdefault("device", "cpu")
    kw.setdefault("heartbeat_timeout_s", 30)
    kw.setdefault("register_timeout_s", 300)
    return ClusterConfig(**kw)


def _rel(x, ref):
    return float(np.linalg.norm(np.asarray(x) - ref) / np.linalg.norm(ref))


def _obj(D, aux, x):
    return logistic_objective(D, aux, np.asarray(x))


# ---------------------------------------------------------------------------
# compression (shared with core/distributed.py)
# ---------------------------------------------------------------------------

def test_quantize_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    for n in (7, 32, 256, 700):
        v = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        q, s = compress.quantize_int8(v)
        r = compress.dequantize_int8(q, s, n)
        assert float(torch.max(torch.abs(v - r))) <= \
            float(torch.max(s)) * 0.5001
        assert q.dtype == torch.int8


def test_adaptive_group_never_inflates_payload():
    assert compress.wire_bytes(32, True) < compress.wire_bytes(32, False)
    assert compress.wire_bytes(512, True) < 0.3 * compress.wire_bytes(
        512, False)


def test_error_feedback_unbiased_over_stream():
    """Summing an EF-compressed stream tracks the true running sum to
    one quantization step."""
    rng = np.random.default_rng(1)
    err = torch.zeros((64,))
    true_sum = np.zeros(64)
    deq_sum = np.zeros(64)
    for _ in range(50):
        v = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
        q, s, err = compress.ef_compress(v, err)
        true_sum += v.numpy()
        deq_sum += compress.dequantize_int8(q, s, 64).numpy()
    np.testing.assert_allclose(deq_sum, true_sum - err.numpy(),
                               rtol=0, atol=1e-4)


def test_shard_map_path_uses_shared_impl():
    from repro_torch.core import distributed
    assert distributed.ef_compress is compress.ef_compress
    assert not hasattr(distributed, "_quantize_int8")
    assert not hasattr(distributed, "_dequantize_int8")


# ---------------------------------------------------------------------------
# reduction container + tree topology
# ---------------------------------------------------------------------------

def test_contribution_encode_decode_merge():
    """The port's wire payloads are the JAX package's, bit for bit: the
    same codes, scales and error-feedback residual for the same vectors,
    all numpy float32 / int8 (no tensor on the wire)."""
    from repro.cluster import reduction as jred
    rng = np.random.default_rng(2)

    def mk(wid, it=3):
        return Contribution(
            iteration=it, workers=(wid,), rows=100 + wid,
            d=rng.standard_normal(24).astype(np.float32),
            w=rng.standard_normal(24).astype(np.float32),
            v=rng.standard_normal(24).astype(np.float32),
            scalars={"r_sq": 1.0 * wid, "dx_sq": 2.0, "y_sq": 3.0,
                     "obj": 4.0})

    a, b = mk(0), mk(1)
    m = a.merge(b)
    assert m.workers == (0, 1) and m.rows == 201
    np.testing.assert_allclose(m.d, a.d + b.d)
    assert m.scalars["r_sq"] == 1.0

    raw, _ = encode(a, compressed=False)
    assert raw["dwv"].dtype == np.float32
    np.testing.assert_array_equal(decode(raw).d, a.d)
    comp, err = encode(a, compressed=True)
    got = decode(comp)
    step = float(np.max(np.abs(a.d))) / 127
    np.testing.assert_allclose(got.d, a.d, atol=0.51 * step + 1e-7)
    assert err is not None and err.dtype == np.float32
    assert comp["q"].dtype == np.int8 and comp["s"].dtype == np.float32
    jcomp, jerr = jred.encode(jred.Contribution(**vars(a)), compressed=True)
    np.testing.assert_array_equal(comp["q"], np.asarray(jcomp["q"]))
    np.testing.assert_array_equal(comp["s"], np.asarray(jcomp["s"]))
    np.testing.assert_array_equal(err, np.asarray(jerr))
    np.testing.assert_array_equal(got.d, jred.decode(jcomp).d)
    with pytest.raises(AssertionError):
        a.merge(mk(2, it=4))                 # cross-iteration merge


@pytest.mark.parametrize("nw,fanout", [(1, 2), (2, 2), (5, 2), (9, 3)])
def test_tree_topology_structure(nw, fanout):
    topo = TreeTopology.build(range(nw), fanout=fanout)
    assert topo.parent(topo.root) is None
    seen = set()
    for wid in topo.order:
        for c in topo.children(wid):
            assert topo.parent(c) == wid
            seen.add(c)
        hops, node = 0, wid
        while topo.parent(node) is not None:
            node = topo.parent(node)
            hops += 1
            assert hops <= nw
        assert node == topo.root
    assert seen == set(topo.order) - {topo.root}
    assert topo.depth() >= 1


def test_membership_assignment_and_reassignment():
    mem = Membership()
    for wid in range(3):
        mem.add(WorkerInfo(wid=wid))
    plan = mem.initial_assignment(10)
    assert sorted(b for bs in plan.values() for b in bs) == list(range(10))
    assert mem.coverage() == set(range(10))
    orphans = mem.mark_dead(1)
    assert orphans and mem.coverage() == set(range(10)) - orphans
    plan2 = mem.reassignment_plan(sorted(orphans))
    assert mem.coverage() == set(range(10))
    assert set(plan2) <= {0, 2}
    loads = [len(mem.get(w).blocks) for w in (0, 2)]
    assert abs(loads[0] - loads[1]) <= 1
    mem.mark_dead(0)
    orphans = mem.mark_dead(2)
    with pytest.raises(DeadCluster):
        mem.reassignment_plan(sorted(orphans))


def test_store_verify_block_detects_tamper():
    D, aux = _problem(400, 8)
    store = ShardedMatrixStore.from_arrays(D, aux, block_rows=128)
    assert all(store.verify_block(k) for k in range(store.nblocks))
    store._blocks_D[1][0, 0] += 1.0
    assert not store.verify_block(1)
    assert store.verify_block(0)


def test_stats_payload_roundtrip():
    from repro_torch.service.stats import SufficientStats
    D, aux = _problem(300, 10)
    st = SufficientStats.from_data(D, aux, device="cpu")
    payload = st.to_payload()
    assert isinstance(payload["G"], np.ndarray)
    rt = SufficientStats.from_payload(payload, device="cpu")
    assert torch.equal(rt.G, st.G)
    assert (rt.rows, rt.fingerprint, rt.labeled_rows) == (
        st.rows, st.fingerprint, st.labeled_rows)
    assert st.merge(rt).rows == 2 * st.rows


# ---------------------------------------------------------------------------
# streaming checkpoint/resume: bitwise after a kill
# ---------------------------------------------------------------------------

def test_streaming_checkpoint_resume_bitwise(tmp_path):
    D, aux = _problem(1500, 20, seed=1)
    store = ShardedMatrixStore.from_arrays(D, aux, block_rows=400)
    solver = UnwrappedADMM(loss=make_logistic(), tau=TAU, device="cpu")
    ref = solver.solve_streaming(store, max_iters=30)
    solver.solve_streaming(store, max_iters=17,
                           checkpoint_dir=str(tmp_path),
                           checkpoint_every=5)
    res = solver.solve_streaming(store, max_iters=30,
                                 checkpoint_dir=str(tmp_path),
                                 checkpoint_every=5, resume=True)
    assert torch.equal(res.x, ref.x)
    assert int(res.iters) == int(ref.iters)
    res2 = solver.solve_streaming(store, max_iters=30,
                                  checkpoint_dir=str(tmp_path),
                                  checkpoint_every=5, resume=True)
    assert torch.equal(res2.x, ref.x)


def test_streaming_checkpoint_refuses_foreign_store(tmp_path):
    D, aux = _problem(600, 12, seed=2)
    store = ShardedMatrixStore.from_arrays(D, aux, block_rows=200)
    solver = UnwrappedADMM(loss=make_logistic(), tau=TAU, device="cpu")
    solver.solve_streaming(store, max_iters=6,
                           checkpoint_dir=str(tmp_path),
                           checkpoint_every=3)
    other = ShardedMatrixStore.from_arrays(D + 1.0, aux, block_rows=200)
    with pytest.raises(ValueError, match="different store"):
        solver.solve_streaming(other, max_iters=6,
                               checkpoint_dir=str(tmp_path), resume=True)


# ---------------------------------------------------------------------------
# real multi-process solves
# ---------------------------------------------------------------------------

def test_config_rejects_staleness_plus_checkpointing(tmp_path):
    from repro_torch.cluster.coordinator import ClusterConfig
    with pytest.raises(ValueError, match="strict synchronous"):
        ClusterConfig(staleness=2, checkpoint_every=5)
    with pytest.raises(ValueError, match="quorum"):
        ClusterConfig(quorum=0.0)
    ClusterConfig(staleness=2)
    # like every entry point, the cluster runs on the card unless asked
    # for the CPU: without one, the coordinator refuses to start
    assert ClusterConfig().device == "cuda"
    if not torch.cuda.is_available():
        from repro_torch.cluster.coordinator import ClusterCoordinator
        D, aux = _problem(200, 4)
        path = ShardedMatrixStore.from_arrays(D, aux, block_rows=100).save(
            str(tmp_path / "store"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ClusterCoordinator(path, {"name": "logistic"})


def test_two_process_compressed_reduction_parity(ref40, tmp_path):
    """2 REAL worker processes, int8-EF tree reduction, land on the
    single-process objective (the compressed-mode bar), and the wire
    really carried int8."""
    from repro_torch.cluster.coordinator import cluster_solve
    D, aux, ref_x = ref40
    res = cluster_solve(D, aux, {"name": "logistic"}, tau=TAU,
                        max_iters=40, config=_cluster_cfg(
                            n_workers=2, compress=True),
                        store_dir=str(tmp_path / "store"),
                        block_rows=300, **TINY)
    assert res.iters == 40
    ref_obj = _obj(D, aux, ref_x)
    assert abs(_obj(D, aux, res.x) - ref_obj) / abs(ref_obj) < 1e-3
    per_iter = res.telemetry["reduction_rx_bytes_per_iter"]
    assert per_iter < 2 * 3 * 4 * D.shape[1]


def test_four_worker_solve_matches_single_process(ref40, tmp_path):
    from repro_torch.cluster.coordinator import cluster_solve
    D, aux, ref_x = ref40
    res = cluster_solve(D, aux, {"name": "logistic"}, tau=TAU,
                        max_iters=40, config=_cluster_cfg(n_workers=4),
                        store_dir=str(tmp_path / "store"),
                        block_rows=150, **TINY)
    rel = _rel(res.x, ref_x)
    assert rel <= 1e-5, rel
    t = res.telemetry
    assert t["workers_alive"] == 4 and not t["deaths"]
    # every block step of every iteration ran in a worker (8 blocks x 40)
    assert sum(w["iters"] for w in t["per_worker"].values()) == 4 * 40
    assert sum(w["block_step_ms"]["count"]
               for w in t["per_worker"].values()) == 8 * 40


def test_worker_sigkill_reassignment_same_answer(ref40, tmp_path):
    """SIGKILL one of 4 workers mid-solve; its blocks are reassigned
    (fingerprint-verified), the new owner replays the x-history, and the
    solve lands on the same x."""
    from repro_torch.cluster.coordinator import cluster_solve
    D, aux, ref_x = ref40
    res = cluster_solve(
        D, aux, {"name": "logistic"}, tau=TAU, max_iters=40,
        config=_cluster_cfg(n_workers=4,
                            worker_overrides={2: {"die_at_iter": 13}}),
        store_dir=str(tmp_path / "store"), block_rows=150, **TINY)
    rel = _rel(res.x, ref_x)
    assert rel <= 1e-5, rel
    t = res.telemetry
    assert t["deaths"] == [2]
    assert t["blocks_reassigned"] >= 1
    assert t["iteration_retries"] >= 1
    assert t["workers_alive"] == 3


def test_cluster_lasso_stats_path(tmp_path):
    """Lasso over the cluster is the paper-section-4 path: one distributed
    stats reduction (fingerprint-complete, the JAX package's fingerprint
    string and Gram), then a local FASTA solve identical to the one on
    the single-process stats."""
    from repro.data.store import ShardedMatrixStore as JStore
    from repro.service.stats import SufficientStats as JStats
    from repro_torch.cluster.coordinator import cluster_stats
    from repro_torch.core.fasta import transpose_reduction_lasso
    from repro_torch.service.stats import SufficientStats
    rng = np.random.default_rng(3)
    m, n = 1600, 24
    D = rng.standard_normal((m, n)).astype(np.float32)
    b = (D @ rng.standard_normal(n).astype(np.float32)
         + 0.1 * rng.standard_normal(m).astype(np.float32))
    store_dir = str(tmp_path / "store")
    st, _ = cluster_stats(D, b, store_dir=store_dir,
                          config=_cluster_cfg(n_workers=4),
                          block_rows=200)
    store = ShardedMatrixStore.open(store_dir)
    ref_st = SufficientStats.from_store(store, device="cpu")
    j_st = JStats.from_store(JStore.open(store_dir))
    assert st.fingerprint == store.fingerprint == ref_st.fingerprint \
        == j_st.fingerprint
    assert st.rows == m and st.fully_labeled
    np.testing.assert_allclose(st.G.numpy(), np.asarray(j_st.G),
                               rtol=1e-5, atol=1e-5 * float(np.abs(
                                   np.asarray(j_st.G)).max()))
    fr = transpose_reduction_lasso(st.G, st.c, mu=5.0, iters=400)
    fr_ref = transpose_reduction_lasso(ref_st.G, ref_st.c, mu=5.0,
                                       iters=400)
    rel = float(torch.linalg.norm(fr.x - fr_ref.x)
                / max(float(torch.linalg.norm(fr_ref.x)), 1e-30))
    assert rel <= 1e-5, rel


def test_cluster_checkpoint_resume(ref40, tmp_path):
    from repro_torch.cluster.coordinator import cluster_solve
    D, aux, ref_x = ref40
    store_dir = str(tmp_path / "store")
    ckpt = str(tmp_path / "ckpt")
    common = dict(tau=TAU, store_dir=store_dir, block_rows=300, **TINY)
    # "killed" after 12 iterations (checkpoints every 5 -> step 10)
    cluster_solve(D, aux, {"name": "logistic"}, max_iters=12,
                  config=_cluster_cfg(n_workers=2, checkpoint_dir=ckpt,
                                      checkpoint_every=5), **common)
    res = cluster_solve(D, aux, {"name": "logistic"}, max_iters=40,
                        config=_cluster_cfg(n_workers=2,
                                            checkpoint_dir=ckpt,
                                            checkpoint_every=5,
                                            resume=True), **common)
    rel = _rel(res.x, ref_x)
    assert rel <= 1e-5, rel
    # resuming the COMPLETED solve (latest checkpoint at 40): zero
    # iterations run, the checkpointed x comes back verbatim
    res2 = cluster_solve(D, aux, {"name": "logistic"}, max_iters=40,
                         config=_cluster_cfg(n_workers=2,
                                             checkpoint_dir=ckpt,
                                             checkpoint_every=5,
                                             resume=True), **common)
    np.testing.assert_array_equal(res2.x, res.x)


def test_bounded_staleness_straggler(ref40, tmp_path):
    """Quorum mode with a deliberate straggler: the coordinator proceeds
    without it (within the staleness bound) and still reaches the
    single-process objective."""
    from repro_torch.cluster.coordinator import cluster_solve
    D, aux, ref_x = ref40
    res = cluster_solve(
        D, aux, {"name": "logistic"}, tau=TAU, max_iters=60,
        config=_cluster_cfg(n_workers=2, staleness=3, quorum=0.5,
                            worker_overrides={1: {"slow_ms": 40}}),
        store_dir=str(tmp_path / "store"), block_rows=300, **TINY)
    ref_obj = _obj(D, aux, ref_x)
    assert abs(_obj(D, aux, res.x) - ref_obj) / abs(ref_obj) < 1e-3


def test_cluster_solve_matches_the_jax_cluster(tmp_path):
    """Both packages' ``cluster_solve`` on the same saved store (written
    by the port, opened by the JAX workers): the same iteration count, x
    within 1e-5, and the coordinator's reduction bytes per iteration
    within 5 % (the same wire format; pickle framing may differ by a few
    bytes)."""
    from repro.cluster.coordinator import ClusterConfig as JConfig
    from repro.cluster.coordinator import cluster_solve as j_cluster_solve
    from repro_torch.cluster.coordinator import cluster_solve
    D, aux = _problem(900, 16, seed=4)
    path = ShardedMatrixStore.from_arrays(D, aux, block_rows=150).save(
        str(tmp_path / "store"))
    kw = dict(tau=TAU, max_iters=25, **TINY)
    res = cluster_solve(path, None, {"name": "logistic"},
                        config=_cluster_cfg(n_workers=2), **kw)
    jres = j_cluster_solve(path, None, {"name": "logistic"},
                           config=JConfig(n_workers=2, jax_platforms="cpu",
                                          heartbeat_timeout_s=30,
                                          register_timeout_s=300), **kw)
    assert res.iters == jres.iters == 25
    rel = _rel(res.x, np.asarray(jres.x))
    assert rel <= 1e-5, rel
    got = res.telemetry["reduction_rx_bytes_per_iter"]
    want = jres.telemetry["reduction_rx_bytes_per_iter"]
    assert abs(got - want) <= 0.05 * want, (got, want)
    jx = JADMM(loss=j_make_logistic(), tau=TAU).run(
        jnp.asarray(D)[None], jnp.asarray(aux)[None], iters=25).x
    assert _rel(res.x, np.asarray(jx)) <= 1e-5


def test_sparse_store_cluster_matches_the_streamed_solve(tmp_path):
    """A sparse store over the cluster: each worker runs the engine's
    sparse body (K6 on the card) on the one-block BlockCSRs it owns, and
    the host Gram comes from the stats reduce. x after 20 iterations
    matches the port's streamed solve of the same store (itself held to
    the JAX package in tests/test_torch_streaming.py)."""
    from repro_torch.cluster.coordinator import cluster_solve
    from repro_torch.data.sparse import BlockCSR
    rng = np.random.default_rng(5)
    m, n = 2000, 32
    mask = rng.random((m, n)) < 0.1
    rows, cols = np.nonzero(mask)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    a = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
    vals = vals + 0.5 * (a[rows] > 0) * (cols < 4)
    tb = BlockCSR.from_coo(rows, cols.astype(np.int32), vals, m, n,
                           block_m=384, device="cpu")
    store = ShardedMatrixStore.from_sparse(tb, a)
    path = store.save(str(tmp_path / "store"))
    res = cluster_solve(path, None, {"name": "logistic"}, tau=TAU,
                        max_iters=20, config=_cluster_cfg(n_workers=2),
                        **TINY)
    solver = UnwrappedADMM(loss=make_logistic(), tau=TAU, device="cpu",
                           **TINY)
    ref = solver.solve_streaming(ShardedMatrixStore.open(path),
                                 max_iters=20)
    assert res.iters == ref.iters == 20
    rel = _rel(res.x, ref.x.numpy())
    assert rel <= 1e-5, rel
