"""Port parity for the elastic, self-healing cluster runtime: the mirror
of ``tests/test_chaos.py`` on ``repro_torch.cluster``. Seeded
deterministic fault injection (the JAX package's schedules, token for
token), hardened transport (frame cap, frame deadline, dial retry),
membership rebalance plans, degrade policies, checkpoint walk-back — and
the acceptance runs on worker processes on the CPU: a 4-worker solve
under kill/hang/join/delay/drop chaos landing on the JAX package's
single-process answer, a coordinator crash and relaunch resuming from its
checkpoint, and a degraded stop. The chaos soak is in
``tests/test_torch_chaos_soak.py`` (a file of its own: it runs about a
minute, mostly waiting out the heartbeat timeout of a SIGSTOPped worker).

Each solve has its own limits so none can hang the suite: the
reference's ``register_timeout_s`` and ``heartbeat_timeout_s``, and its
``DegradePolicy(iter_deadline_s=...)`` where the reference uses one.

The relaunch case passes steadily because the port's worker counts a
register that fails on a link that just connected as a failed dial (the
reference's worker exits on it, ``repro/cluster/worker.py:160-178``), and
the port's ``crash()`` waits for its accept thread, so the crashed
port's listening socket is gone before the relaunch binds it (ROADMAP
section 3)."""
import pickle
import socket
import struct
import threading
import time

import numpy as np
import jax
import pytest
import torch

from repro_torch.cluster.chaos import (
    NOOP,
    ChaosSchedule,
    FaultEvent,
    FaultInjector,
    make_injector,
)
from repro_torch.cluster.membership import DeadCluster, Membership, WorkerInfo
from repro_torch.cluster.reduction import Contribution, decode, encode
from repro_torch.cluster.transport import (
    Connection,
    ConnectionClosed,
    Listener,
    connect,
)
from repro.core.prox import make_logistic
from repro.core.unwrapped import UnwrappedADMM
from repro_torch.data.store import ShardedMatrixStore

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

TAU = 0.1
TINY = dict(eps_rel=1e-9, eps_abs=1e-12)   # fixed-iteration parity runs


def _problem(m=1200, n=20, seed=0):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n)).astype(np.float32)
    aux = np.sign(rng.standard_normal((m,))).astype(np.float32)
    return D, aux


def _reference(D, aux, iters):
    """The JAX package's single-process x after ``iters`` iterations."""
    solver = UnwrappedADMM(loss=make_logistic(), tau=TAU)
    return np.asarray(solver.run(D[None], aux[None], iters=iters).x)


def _cluster_cfg(**kw):
    from repro_torch.cluster.coordinator import ClusterConfig
    kw.setdefault("device", "cpu")
    kw.setdefault("heartbeat_timeout_s", 30)
    kw.setdefault("register_timeout_s", 300)
    return ClusterConfig(**kw)


# ---------------------------------------------------------------------------
# schedule: tokens, round-trip, seeded determinism
# ---------------------------------------------------------------------------

def test_fault_event_token_roundtrip():
    e = FaultEvent(iteration=13, target="w2", kind="kill")
    assert e.to_token() == "kill@13:w2"
    assert FaultEvent.from_token("kill@13:w2") == e
    d = FaultEvent(iteration=5, target="w0", kind="delay", param=80.0)
    assert FaultEvent.from_token(d.to_token()) == d
    for bad in ("kill@x:w2", "frob@3:w1", "kill@-1:w0", "kill13w2"):
        with pytest.raises(ValueError):
            FaultEvent.from_token(bad)


def test_schedule_spec_roundtrip_and_sorting():
    spec = "kill@13:w2,delay@5:w0:80,join@9:w4"
    s = ChaosSchedule.parse(spec)
    # events come out iteration-sorted regardless of spec order
    assert [e.iteration for e in s.events] == [5, 9, 13]
    assert ChaosSchedule.parse(s.to_spec()).events == s.events


def test_schedule_generate_deterministic_and_roundtrips():
    from repro.cluster.chaos import ChaosSchedule as JChaosSchedule
    for seed in range(10):
        a = ChaosSchedule.generate(seed, n_workers=4, iters=40)
        b = ChaosSchedule.generate(seed, n_workers=4, iters=40)
        assert a.events == b.events and a.seed == seed
        assert ChaosSchedule.parse(a.to_spec()).events == a.events
        # the same seed schedules the same faults in both packages
        assert a.to_spec() == JChaosSchedule.generate(
            seed, n_workers=4, iters=40).to_spec()
    assert (ChaosSchedule.generate(0, n_workers=4, iters=40).events
            != ChaosSchedule.generate(1, n_workers=4, iters=40).events)


def test_schedule_generate_validation_and_victim_disjointness():
    with pytest.raises(ValueError, match="survivor"):
        ChaosSchedule.generate(0, n_workers=2, iters=40, kills=1, stops=1)
    with pytest.raises(ValueError, match="iterations"):
        ChaosSchedule.generate(0, n_workers=4, iters=4)
    s = ChaosSchedule.generate(3, n_workers=4, iters=40, kills=2, stops=1)
    victims = [e.target for e in s.for_kind("kill", "stop")]
    assert len(victims) == len(set(victims)) == 3
    joins = s.for_kind("join")
    assert all(e.target == "w4" for e in joins)   # fresh wid, above 0..3
    assert s.counts()["kill"] == 2


# ---------------------------------------------------------------------------
# injector: no-op fast path, fire-once semantics, plane filtering
# ---------------------------------------------------------------------------

def test_make_injector_noop_singleton():
    assert make_injector(None, "w0") is NOOP
    assert make_injector("", "w0") is NOOP
    # a spec with no events for this target also costs nothing
    assert make_injector("kill@3:w1", "w0") is NOOP
    assert not NOOP.enabled
    assert NOOP.process_actions(3) == () and NOOP.on_send("contrib") == ()


def test_injector_process_faults_fire_once_at_or_after_iteration():
    inj = FaultInjector(ChaosSchedule.parse("slow@5:w0:30,kill@7:w0")
                        .for_target("w0"))
    assert inj.process_actions(4) == ()
    # iteration 6 skipped straight to 8: both fire (>=), exactly once
    assert inj.process_actions(8) == (("slow", 30.0), ("kill", 0.0))
    assert inj.process_actions(9) == ()
    assert inj.pending() == ()


def test_injector_wire_faults_exact_iteration_data_plane_only():
    inj = FaultInjector(ChaosSchedule.parse("drop@5:w0").for_target("w0"))
    inj.set_iteration(4)
    assert inj.on_send("contrib") == ()      # wrong iteration: no fire
    inj.set_iteration(5)
    assert inj.on_send("heartbeat") == ()    # control plane stays clean
    assert inj.on_send("contrib") == (("drop", 0.0),)
    assert inj.on_send("contrib") == ()      # fired once


def test_injector_corrupt_breaks_pickle_deterministically():
    inj = FaultInjector(())
    frame = pickle.dumps({"type": "contrib", "x": np.arange(4)})
    bad = inj.corrupt(frame)
    assert bad == inj.corrupt(frame) and bad != frame
    with pytest.raises(Exception):
        pickle.loads(bad)


# ---------------------------------------------------------------------------
# transport hardening: frame cap, frame deadline, decode, dial retry
# ---------------------------------------------------------------------------

def _conn_pair(**kw):
    """A real TCP (client, server) Connection pair on localhost."""
    lst = Listener()
    out = {}

    def _accept():
        out["srv"] = lst.accept(timeout=5.0)

    t = threading.Thread(target=_accept)
    t.start()
    cli = connect(lst.address)
    t.join()
    lst.close()
    srv = out["srv"]
    for k, v in kw.items():
        setattr(cli, k, v)
        setattr(srv, k, v)
    return cli, srv


def test_frame_length_cap_kills_connection():
    cli, srv = _conn_pair(max_frame_bytes=1 << 16)
    cli._sock.sendall(struct.pack(">Q", 1 << 40) + b"xx")
    with pytest.raises(ConnectionClosed, match="exceeds cap"):
        srv.recv(timeout=5.0)
    assert srv.closed
    cli.close()


def test_partial_frame_hits_completion_deadline():
    cli, srv = _conn_pair(frame_deadline_s=0.4)
    cli._sock.sendall(b"\x00\x00\x00")        # 3 of 8 header bytes, then hang
    t0 = time.monotonic()
    with pytest.raises(ConnectionClosed, match="stalled mid-receive"):
        srv.recv(timeout=5.0)
    assert time.monotonic() - t0 < 3.0        # deadline, not the idle timeout
    cli.close()


def test_idle_timeout_with_zero_bytes_returns_none():
    cli, srv = _conn_pair()
    assert srv.recv(timeout=0.2) is None      # idle != dead
    cli.send("ping")
    assert srv.recv(timeout=5.0)["type"] == "ping"
    cli.close()
    srv.close()


def test_undecodable_frame_kills_connection():
    cli, srv = _conn_pair()
    junk = b"\xff\xfenot a pickle"
    cli._sock.sendall(struct.pack(">Q", len(junk)) + junk)
    with pytest.raises(ConnectionClosed, match="undecodable"):
        srv.recv(timeout=5.0)
    cli.close()


def test_connect_retry_backoff_then_failure():
    # grab a port with no listener behind it
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = s.getsockname()
    s.close()
    t0 = time.monotonic()
    with pytest.raises(ConnectionClosed, match="3 attempt"):
        connect(addr, timeout=0.5, retries=2, backoff_s=0.05,
                backoff_max_s=0.1)
    assert time.monotonic() - t0 >= 0.1       # it actually backed off


def test_connect_retry_reaches_late_listener():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = s.getsockname()
    s.close()
    lst = {}

    def _bind_late():
        time.sleep(0.3)
        lst["l"] = Listener(host=addr[0], port=addr[1])

    t = threading.Thread(target=_bind_late)
    t.start()
    conn = connect(addr, timeout=0.5, retries=6, backoff_s=0.1,
                   backoff_max_s=0.5)
    t.join()
    conn.close()
    lst["l"].close()


# ---------------------------------------------------------------------------
# chaos-driven wire faults on a live connection
# ---------------------------------------------------------------------------

def _wire_injector(spec, it):
    inj = make_injector(spec, "w0")
    inj.set_iteration(it)
    return inj


def test_chaos_drop_and_dup_on_send():
    cli, srv = _conn_pair()
    cli.chaos = _wire_injector("drop@3:w0,dup@4:w0", 3)
    cli.send("contrib", k=1)                  # dropped: never arrives
    assert srv.recv(timeout=0.3) is None
    # dropped frames still count as tx (the bytes "left" the app)
    assert cli.counter.snapshot()["sent_bytes"]["contrib"] > 0
    cli.chaos.set_iteration(4)
    cli.send("contrib", k=2)                  # duplicated: arrives twice
    assert srv.recv(timeout=5.0)["k"] == 2
    assert srv.recv(timeout=5.0)["k"] == 2
    cli.close()
    srv.close()


def test_chaos_corrupt_surfaces_as_dead_link():
    cli, srv = _conn_pair()
    cli.chaos = _wire_injector("corrupt@2:w0", 2)
    cli.send("contrib", k=1)
    with pytest.raises(ConnectionClosed, match="undecodable"):
        srv.recv(timeout=5.0)
    cli.close()


def test_chaos_reset_raises_at_sender():
    cli, srv = _conn_pair()
    cli.chaos = _wire_injector("reset@2:w0", 2)
    with pytest.raises(ConnectionClosed, match="chaos"):
        cli.send("contrib", k=1)
    assert cli.closed
    with pytest.raises(ConnectionClosed):
        srv.recv(timeout=5.0)
    srv.close()


def test_chaos_delay_sleeps_but_delivers():
    cli, srv = _conn_pair()
    cli.chaos = _wire_injector("delay@2:w0:150", 2)
    t0 = time.monotonic()
    cli.send("contrib", k=1)
    assert time.monotonic() - t0 >= 0.14
    assert srv.recv(timeout=5.0)["k"] == 1
    cli.close()
    srv.close()


def test_control_plane_immune_to_wire_faults():
    cli, srv = _conn_pair()
    cli.chaos = _wire_injector("drop@2:w0", 2)
    cli.send("heartbeat", t=1.0)              # not data plane: untouched
    assert srv.recv(timeout=5.0)["type"] == "heartbeat"
    cli.close()
    srv.close()


# ---------------------------------------------------------------------------
# membership: liveness interleavings + rebalance plans
# ---------------------------------------------------------------------------

def test_membership_stale_beat_interleaving():
    mem = Membership()
    for wid in range(3):
        mem.add(WorkerInfo(wid=wid))
    assert mem.stale(timeout=0.2) == []
    time.sleep(0.25)
    mem.beat(1)                               # only 1 stays fresh
    assert mem.stale(timeout=0.2) == [0, 2]
    mem.beat(0)
    mem.beat(2)
    assert mem.stale(timeout=0.2) == []
    mem.beat(99)                              # unknown wid: ignored
    mem.mark_dead(2)
    time.sleep(0.25)
    assert mem.stale(timeout=0.2) == [0, 1]   # the dead never re-stale


def test_mark_dead_idempotent():
    mem = Membership()
    mem.add(WorkerInfo(wid=0, blocks={1, 2}))
    assert mem.mark_dead(0) == {1, 2}
    assert mem.mark_dead(0) == set()          # already dead: no orphans
    assert mem.mark_dead(7) == set()          # never registered
    assert mem.deaths == [0]                  # recorded exactly once


def test_rebalance_plan_levels_loads():
    mem = Membership()
    mem.add(WorkerInfo(wid=0, blocks=set(range(8))))
    mem.add(WorkerInfo(wid=1, blocks={8, 9}))
    mem.add(WorkerInfo(wid=2, blocks=set()))  # the joiner
    gains, losses = mem.rebalance_plan()
    loads = [len(mem.get(w).blocks) for w in (0, 1, 2)]
    assert max(loads) - min(loads) <= 1
    assert sum(loads) == 10                   # nothing created or lost
    assert mem.coverage() == set(range(10))
    moved_out = [b for bs in losses.values() for b in bs]
    moved_in = [b for bs in gains.values() for b in bs]
    assert sorted(moved_out) == sorted(moved_in)
    assert mem.rebalances == len(moved_in)
    # already level: a second pass is a no-op
    g2, l2 = mem.rebalance_plan()
    assert not g2 and not l2


def test_rebalance_plan_deterministic():
    def build():
        mem = Membership()
        mem.add(WorkerInfo(wid=0, blocks={0, 1, 2, 3, 4}))
        mem.add(WorkerInfo(wid=1, blocks={5, 6, 7, 8, 9}))
        mem.add(WorkerInfo(wid=2, blocks=set()))
        return mem

    assert build().rebalance_plan() == build().rebalance_plan()


def test_rebalance_plan_dead_cluster():
    mem = Membership()
    mem.add(WorkerInfo(wid=0, blocks={0}))
    mem.mark_dead(0)
    with pytest.raises(DeadCluster):
        mem.rebalance_plan()


# ---------------------------------------------------------------------------
# payload validation, degrade policy, store batch verify, checkpoint
# ---------------------------------------------------------------------------

def test_decode_rejects_malformed_payloads():
    c = Contribution(iteration=3, workers=(0,), rows=10,
                     d=np.ones(4, np.float32), w=np.ones(4, np.float32),
                     v=np.ones(4, np.float32),
                     scalars={"r_sq": 1., "dx_sq": 1., "y_sq": 1.,
                              "obj": 1.})
    good, _ = encode(c, compressed=False)
    assert decode(good).rows == 10
    for mutate in (
        lambda p: p.pop("scalars"),
        lambda p: p.__setitem__("dwv", p["dwv"][:2]),       # (2, n)
        lambda p: p.__setitem__("n", "NaNsense"),
        lambda p: p.__setitem__("rows", -4),
        lambda p: p.__setitem__("workers", [None]),
    ):
        p = {**good, "scalars": dict(good["scalars"])}
        mutate(p)
        with pytest.raises(ValueError):
            decode(p)


def test_degrade_policy_validation():
    from repro_torch.cluster.coordinator import DegradePolicy
    DegradePolicy()                           # defaults are legal
    with pytest.raises(ValueError, match="min_quorum"):
        DegradePolicy(min_quorum=0.0)
    with pytest.raises(ValueError, match="positive"):
        DegradePolicy(iter_deadline_s=0.0)
    with pytest.raises(ValueError):
        DegradePolicy(deadline_retries=-1)


def test_cluster_config_normalizes_chaos_spec():
    cfg = _cluster_cfg(n_workers=4, chaos="kill@13:w2,join@9:w4")
    assert isinstance(cfg.chaos, ChaosSchedule)
    assert cfg.chaos.for_kind("join")[0].target == "w4"
    with pytest.raises(ValueError):
        _cluster_cfg(n_workers=0, spawn=False)


def test_store_verify_blocks_batch():
    D, aux = _problem(400, 8)
    store = ShardedMatrixStore.from_arrays(D, aux, block_rows=128)
    assert store.verify_blocks(range(store.nblocks)) == []
    store._blocks_D[1][0, 0] += 1.0
    store._blocks_D[2][0, 0] += 1.0
    assert store.verify_blocks(range(store.nblocks)) == [1, 2]


def test_checkpoint_restore_walks_back_past_corruption(tmp_path):
    from repro_torch.checkpoint.manager import CheckpointManager
    mgr = CheckpointManager(str(tmp_path))
    like = {"x": np.zeros(4, np.float32)}
    mgr.save(5, {"x": np.full(4, 5.0, np.float32)})
    mgr.save(10, {"x": np.full(4, 10.0, np.float32)})
    # rot the newest step's leaf on disk
    leaf = tmp_path / "step_00000010" / "leaf_0.npy"
    np.save(leaf, np.full(4, 99.0, np.float32))
    with pytest.raises(IOError, match="corruption"):
        mgr.restore(like)                     # default: newest, loud
    tree, extra = mgr.restore(like, fallback=True)
    np.testing.assert_array_equal(np.asarray(tree["x"]),
                                  np.full(4, 5.0, np.float32))
    # every step rotten -> IOError, not silence
    np.save(tmp_path / "step_00000005" / "leaf_0.npy",
            np.full(4, 99.0, np.float32))
    with pytest.raises(IOError, match="every checkpoint step"):
        mgr.restore(like, fallback=True)


# ---------------------------------------------------------------------------
# end-to-end: fast 2-process chaos run (wire faults + deadline retry)
# ---------------------------------------------------------------------------

def test_two_worker_wire_chaos_exact(tmp_path):
    """delay + dup + drop on real worker links. The dup is deduped by
    the contribution's worker set, the drop is recovered by one
    deadline-retry re-broadcast (cached answers), and the answer is
    EXACT — not merely close."""
    from repro_torch.cluster.coordinator import DegradePolicy, cluster_solve
    D, aux = _problem()
    ref_x = _reference(D, aux, iters=12)
    spec = "delay@4:w0:60,dup@6:w1,drop@8:w1"
    res = cluster_solve(
        D, aux, {"name": "logistic"}, tau=TAU, max_iters=12,
        config=_cluster_cfg(
            n_workers=2, chaos=spec,
            degrade=DegradePolicy(iter_deadline_s=6.0,
                                  deadline_retries=3)),
        store_dir=str(tmp_path / "store"), block_rows=300, **TINY)
    rel = np.linalg.norm(res.x - ref_x) / np.linalg.norm(ref_x)
    assert rel <= 1e-5, rel
    t = res.telemetry
    assert res.status in ("converged", "max_iters") and res.iters == 12
    assert t["status"] == res.status
    assert t["chaos_spec"] == spec
    assert not t["deaths"]                    # wire faults kill nobody
    assert t["iteration_retries"] >= 1        # the drop cost one retry
    retry_kinds = {e["kind"] for e in t["recovery"]["events"]}
    assert "deadline_retry" in retry_kinds


# ---------------------------------------------------------------------------
# acceptance soaks
# ---------------------------------------------------------------------------

def test_coordinator_crash_relaunch_resumes_from_checkpoint(tmp_path):
    """Coordinator recovery: kill the coordinator (no handshake) after
    a checkpoint, relaunch it on the SAME port with spawn=False, and
    the surviving workers re-register (backoff dial); the relaunch
    restores the newest checkpoint and finishes to the single-process
    answer."""
    from repro_torch.cluster.coordinator import ClusterConfig, ClusterCoordinator
    D, aux = _problem()
    ref_x = _reference(D, aux, iters=40)
    store = ShardedMatrixStore.from_arrays(D, aux, block_rows=300)
    store_path = store.save(str(tmp_path / "store"))
    ckpt = str(tmp_path / "ckpt")
    reconnect = {"retries": 10, "backoff_s": 0.5, "backoff_max_s": 2.0}
    common = dict(device="cpu", heartbeat_timeout_s=30,
                  register_timeout_s=300, checkpoint_dir=ckpt,
                  checkpoint_every=5, reconnect=reconnect)
    c1 = ClusterCoordinator(store_path, {"name": "logistic"}, tau=TAU,
                            config=ClusterConfig(n_workers=2, **common),
                            **TINY)
    c2 = None
    procs = {}
    try:
        c1.start()
        port = c1.listener.address[1]
        res1 = c1.solve(max_iters=14)         # checkpoints at 5 and 10
        assert res1.iters == 14
        procs = dict(c1._procs)
        c1.crash()                            # no stop handshake: links die
        c2 = ClusterCoordinator(
            store_path, {"name": "logistic"}, tau=TAU,
            config=ClusterConfig(n_workers=2, spawn=False, port=port,
                                 resume=True, **common), **TINY)
        c2.adopt_processes(procs)
        res2 = c2.solve(max_iters=40)         # workers re-register first
    finally:
        if c2 is not None:
            c2.shutdown()
        for p in procs.values():              # belt and braces
            if p.is_alive():
                p.kill()
    assert res2.iters == 40
    assert res2.telemetry["iters"] == 30      # resumed at 10, ran 30 more
    assert sorted(c2.members.workers) == [0, 1]
    rel = np.linalg.norm(res2.x - ref_x) / np.linalg.norm(ref_x)
    assert rel <= 1e-5, rel


def test_degraded_status_when_quorum_unrecoverable(tmp_path):
    """Graceful degradation: kill 2 of 3 workers with a min_quorum that
    their deaths violate — the solve returns best-so-far x with
    status='degraded' instead of hanging or raising."""
    from repro_torch.cluster.coordinator import DegradePolicy, cluster_solve
    D, aux = _problem()
    res = cluster_solve(
        D, aux, {"name": "logistic"}, tau=TAU, max_iters=40,
        config=_cluster_cfg(
            n_workers=3, chaos="kill@6:w0,kill@8:w1",
            degrade=DegradePolicy(iter_deadline_s=30.0,
                                  deadline_retries=1,
                                  min_quorum=0.5)),
        store_dir=str(tmp_path / "store"), block_rows=200, **TINY)
    assert res.status == "degraded"
    assert res.telemetry["status"] == "degraded"
    assert res.iters < 40                     # stopped early, not hung
    assert np.all(np.isfinite(res.x))
    assert sorted(res.telemetry["deaths"]) == [0, 1]
