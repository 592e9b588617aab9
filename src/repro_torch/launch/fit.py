"""GLM fitting launcher — the paper's end-to-end fitting program; port of
``repro/launch/fit.py``.

``python -m repro_torch.launch.fit --problem lasso --nodes 320
     --rows-per-node 50000 --features 200 --heterogeneous``

The data come from the port's generators (``lasso_problem`` for lasso,
``classification_problem`` otherwise) and the solve is ``fit()`` with
``--method transpose`` (the paper), ``consensus`` (the Boyd baseline) or
``fasta`` (lasso: the same Gram path), as in the JAX CLI. It runs on the
card (``--device cuda``) unless asked for the CPU; the result lines
(lasso: the KKT violation and support error; logistic: objective and
training accuracy; SVM: objective) are computed on the device, in float64
sums over row blocks, without a host copy of D.

``--density p`` generates SPARSE data instead (the reference's
``sparse_lasso_problem`` / ``sparse_classification_problem``, N x m_i rows
at Bernoulli density p): ``--sparse-format blockcsr`` (the default) solves
over the padded block-CSR (K6 on the card) and prints O(nnz) result lines;
``dense`` densifies and takes the dense path.

``--executor streaming`` (``--streaming`` is its deprecated alias) is the
out-of-core path (DESIGN.md section 9): the data are staged into a host
``ShardedMatrixStore`` (memory-mapped under ``--store-dir``) whose block
height fits ``--device-budget-mb``, and the solve streams the blocks
through the fused body; ``--checkpoint-dir`` / ``--checkpoint-every`` /
``--resume`` checkpoint it and resume it bit for bit. The lasso takes
the stats path there: ``SufficientStats.from_store`` (one K2b launch per
block on the card), then FASTA on the Gram.

``--executor shard_map`` (``--multi-device`` is its deprecated alias)
shards the rows of the logistic and SVM solves over the ranks of a
``torch.distributed`` group, under the shared driver (other problems and
methods take the local path, as in the JAX CLI). Under ``torchrun`` each
rank joins the group from the environment. Alone, the CLI starts one rank
per visible card (NCCL), or on the CPU as many gloo ranks as
``REPRO_TORCH_CPU_RANKS`` says (default 1); the data are made once and
shared with the ranks. A world of one runs in this process and starts no
process group.

``--executor cluster --workers N`` (``--cluster N`` is its deprecated
alias) stages the data into a block store (``--store-dir``, else a
temporary directory), spawns N worker processes on ``--device`` (on the
card they share it when there are fewer cards than workers) and solves
through the fault-tolerant coordinator (DESIGN.md section 11):
``--cluster-compress`` (int8 error feedback on every reduce hop),
``--cluster-staleness`` (bounded-staleness quorum), ``--chaos-seed`` /
``--chaos-spec`` (seeded fault injection), ``--min-quorum`` /
``--iter-deadline`` (graceful degradation) and the checkpoint flags. The
lasso takes the stats path there: one distributed stats reduction, then
FASTA on the Gram.

``--obs-dir`` writes the observability artifacts (trace.json,
metrics.json, telemetry.jsonl; summarize with
``python -m repro_torch.launch.obs_report``). On the cluster path the
coordinator owns the run directory and merges its workers' traces and
metrics into it.
"""
from __future__ import annotations

import argparse
import os
import time
import warnings

import torch

from repro_torch.core.fit import FitResult
from repro_torch.core.fit import fit as fit_glm
from repro_torch.core.prox import make_hinge, make_logistic
from repro_torch.data import sparse as sparse_data
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.obs import Observability

BLOCK_ROWS = 1 << 20


def _blocks(D2: torch.Tensor, v: torch.Tensor):
    for s in range(0, D2.shape[0], BLOCK_ROWS):
        yield D2[s:s + BLOCK_ROWS], v[s:s + BLOCK_ROWS]


def lasso_kkt_gap(D2: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                  mu: float):
    """``oracles.lasso_kkt_gap`` on the data's device: (inf-norm violation,
    support error) of the lasso optimality conditions, with
    D^T(Dx - b) summed in float64 over row blocks."""
    x64 = x.double()
    corr = torch.zeros_like(x64)
    for Db, bb in _blocks(D2, b):
        Db = Db.double()
        corr += Db.T @ (Db @ x64 - bb.double())
    viol = max(float(torch.max(torch.abs(corr))) - mu, 0.0)
    sup = torch.abs(x64) > 1e-7
    sup_err = float(torch.max(torch.abs(corr[sup] + mu * torch.sign(
        x64[sup])))) if bool(sup.any()) else 0.0
    return viol, sup_err


def classifier_summary(D2: torch.Tensor, a: torch.Tensor, x: torch.Tensor):
    """(sum softplus(-a Dx), sum hinge(1 - a Dx), training accuracy) on
    the device, in float64 sums over row blocks."""
    x64 = x.double()
    logi = hinge = hits = 0.0
    zero = torch.zeros((), dtype=torch.float64, device=D2.device)
    for Db, ab in _blocks(D2, a):
        z = Db.double() @ x64
        ab = ab.double()
        logi += float(torch.sum(torch.logaddexp(zero, -ab * z)))
        hinge += float(torch.sum(torch.clamp(1.0 - ab * z, min=0.0)))
        hits += float(torch.sum(torch.sign(z) == ab))
    return logi, hinge, hits / D2.shape[0]


def _admm_params(problem):
    """(loss, rho, tau, loss spec) of the separable-loss ADMM paths (the
    reference's table, ``repro/launch/fit.py::_admm_params``)."""
    if problem == "logistic":
        return make_logistic(), 0.0, 0.1, {"name": "logistic"}
    return make_hinge(1.0), 1.0, 0.5, {"name": "hinge", "C": 1.0}


def _fit_cluster(args, D, aux, mu, dev):
    """Multi-process fit: stage a shared block store, spawn workers,
    solve through the cluster coordinator (DESIGN.md section 11)."""
    from repro_torch.cluster.chaos import ChaosSchedule
    from repro_torch.cluster.coordinator import (
        ClusterConfig,
        DegradePolicy,
        cluster_solve,
        cluster_stats,
    )

    chaos = None
    if args.chaos_spec:
        chaos = ChaosSchedule.parse(args.chaos_spec)
    elif args.chaos_seed is not None:
        # scale the default fault mix down so small clusters keep a
        # survivor (generate refuses kills+stops >= n_workers)
        chaos = ChaosSchedule.generate(args.chaos_seed,
                                       n_workers=args.cluster,
                                       iters=args.iters,
                                       kills=1 if args.cluster > 1 else 0,
                                       stops=1 if args.cluster > 2 else 0)
    degrade = None
    if args.min_quorum is not None or args.iter_deadline is not None:
        degrade = DegradePolicy(
            min_quorum=(args.min_quorum if args.min_quorum is not None
                        else 0.25),
            iter_deadline_s=(args.iter_deadline
                             if args.iter_deadline is not None else 60.0),
        )
    cfg = ClusterConfig(
        n_workers=args.cluster,
        compress=args.cluster_compress,
        staleness=args.cluster_staleness,
        quorum=0.5 if args.cluster_staleness else 1.0,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        device=str(dev),
        obs_dir=args.obs_dir,   # the coordinator owns the run directory
        chaos=chaos,
        degrade=degrade,
        # faults are survivable only if killed workers come back
        reconnect={"retries": 8} if chaos is not None else None,
    )
    if chaos is not None:
        print(f"chaos: seed={chaos.seed} spec={chaos.to_spec()!r}",
              flush=True)
    # the block store lives on the host: the workers map it
    D, aux = D.cpu().numpy(), aux.cpu().numpy()
    if args.problem == "lasso":
        from repro_torch.core.fasta import transpose_reduction_lasso
        stats, telemetry = cluster_stats(D, aux, store_dir=args.store_dir,
                                         config=cfg)
        wire = sum(telemetry["workers"].get("sent_bytes", {}).values())
        print(f"cluster stats: {stats.rows} rows over {args.cluster} "
              f"workers, {wire} worker-tx bytes total", flush=True)
        fr = transpose_reduction_lasso(stats.G, stats.c, mu,
                                       iters=args.iters)
        return FitResult(fr.x, int(fr.iters), fr.objective, "transpose",
                         "lasso")
    if args.problem not in ("logistic", "svm"):
        raise SystemExit(f"--executor cluster does not support "
                         f"{args.problem!r} "
                         f"(needs a separable ProxLoss on Dx)")
    _, rho, tau, spec = _admm_params(args.problem)
    res = cluster_solve(D, aux, spec, tau=tau, rho=rho,
                        max_iters=args.iters, store_dir=args.store_dir,
                        config=cfg)
    t = res.telemetry
    print(f"cluster: {t['workers_alive']}/{t['workers_spawned']} workers "
          f"alive on {dev}, {len(t['deaths'])} deaths, "
          f"{t['blocks_reassigned']} blocks reassigned, "
          f"{t['reduction_rx_bytes_per_iter']:.0f} reduction B/iter "
          f"at the coordinator "
          f"({t['payload_bytes_per_nvec']} B payload per n-vector)",
          flush=True)
    rec = t.get("recovery") or {}
    if t.get("status") != "converged" or t.get("joins") or rec.get("events"):
        print(f"cluster status: {t.get('status')} — "
              f"{t.get('joins', 0)} joins, "
              f"{t.get('blocks_rebalanced', 0)} blocks rebalanced, "
              f"{len(rec.get('events', []))} recovery events "
              f"(time-to-recover "
              f"{rec.get('time_to_recover_s') or 0.0:.2f}s, "
              f"{rec.get('iterations_retried', 0)} iterations retried), "
              f"{t.get('degraded_rounds', 0)} degraded rounds",
              flush=True)
    hist = (torch.tensor(res.history["objective"])
            if res.history else None)
    return FitResult(torch.from_numpy(res.x).to(dev), int(res.iters), hist,
                     "transpose", args.problem)


def _fit_streaming(args, D, aux, mu, dev, obs=None):
    """Out-of-core fit: stage into a host block store, stream the solve.
    ``D`` may be dense node-stacked or a BlockCSR (nnz-scaled store)."""
    from repro_torch.core.unwrapped import UnwrappedADMM
    from repro_torch.data.sparse import BlockCSR
    from repro_torch.data.store import ShardedMatrixStore
    from repro_torch.engine import autotune
    from repro_torch.service.stats import SufficientStats

    budget = args.device_budget_mb * 2 ** 20
    if isinstance(D, BlockCSR):
        # the pipeline holds up to 4 blocks in flight (DESIGN.md section
        # 9): re-block when 4x the per-block bytes exceed the budget
        per_block = D.nbytes // max(D.nblocks, 1)
        if 4 * per_block > budget:
            bytes_per_row = max(per_block // D.block_m, 1)
            D = D.reblock(max(8, budget // (4 * bytes_per_row)))
        store = ShardedMatrixStore.from_sparse(D, aux)
    else:
        n = D.shape[-1]
        D2 = D.reshape(-1, n)
        br = autotune.streaming_block_rows(D2.shape[0], n, D.dtype,
                                           budget_bytes=budget)
        store = ShardedMatrixStore.from_arrays(D2, aux.reshape(-1),
                                               block_rows=br)
    if args.store_dir:
        store = ShardedMatrixStore.open(store.save(args.store_dir))
    print(f"store: {store} (budget {args.device_budget_mb} MiB "
          f"-> {store.nblocks} blocks)", flush=True)
    if args.problem == "lasso":
        # quadratic data term: one stats pass over the store, then FASTA
        # on the cached Gram; no iteration touches the rows again
        from repro_torch.core.fasta import transpose_reduction_lasso
        stats = SufficientStats.from_store(store, device=dev)
        fr = transpose_reduction_lasso(stats.G, stats.c, mu,
                                       iters=args.iters)
        return FitResult(fr.x, int(fr.iters), fr.objective, "transpose",
                         "lasso")
    if args.problem not in ("logistic", "svm"):
        raise SystemExit(f"--executor streaming does not support "
                         f"{args.problem!r} "
                         f"(needs a separable ProxLoss on Dx)")
    loss, rho, tau, _ = _admm_params(args.problem)
    solver = UnwrappedADMM(loss=loss, tau=tau, rho=rho, device=dev)
    res = solver.solve_streaming(store, max_iters=args.iters, record=True,
                                 checkpoint_dir=args.checkpoint_dir,
                                 checkpoint_every=args.checkpoint_every,
                                 resume=args.resume, obs=obs)
    return FitResult(res.x, int(res.iters), res.history.objective,
                     "transpose", args.problem)


def _fit_shard_map(args, D, aux, dev):
    """The shard_map solve under the shared driver: in this process under
    ``torchrun`` (its group) or at a world of one (``SOLO``), else on new
    ranks sharing D."""
    from repro_torch.exec.shard_map import fit_rank
    from repro_torch.sharding import compat

    n = D.shape[-1]
    call = {"problem": args.problem, "D": D.reshape(-1, n),
            "aux": aux.reshape(-1), "max_iters": args.iters,
            "record": True}
    world = compat.local_world(dev)
    if compat.launched_by_torchrun() or world == 1:  # main entered the group
        out = fit_rank([call], str(dev))[0]
    else:
        backend = compat.layout_backend(dev, world)
        threads = max(1, (os.cpu_count() or 1) // world) \
            if dev.type == "cpu" else None
        out = compat.spawn(fit_rank, world, backend, args=([call], str(dev)),
                           device=dev, threads=threads)[0][0]
    print(f"shard_map: {out['extra']['shards']} ranks on "
          f"{out['extra']['group_backend']}", flush=True)
    x = torch.as_tensor(out["x"]).to(dev)
    return FitResult(x, int(out["iters"]), torch.as_tensor(out["objective"]),
                     "transpose", args.problem)


def _fit_sparse(args, bcsr, aux, mu, dev, obs=None):
    """In-memory sparse fit over the engine's block-CSR body."""
    from repro_torch.core.fasta import transpose_reduction_lasso
    from repro_torch.core.unwrapped import UnwrappedADMM
    from repro_torch.service.stats import SufficientStats

    if args.method != "transpose":
        raise SystemExit("--density with blockcsr supports --method "
                         "transpose only (consensus is a dense-data path)")
    print(f"sparse: {bcsr}", flush=True)
    if args.problem == "lasso":
        stats = SufficientStats.from_data(bcsr, aux)
        fr = transpose_reduction_lasso(stats.G, stats.c, mu,
                                       iters=args.iters)
        return FitResult(fr.x, int(fr.iters), fr.objective, "transpose",
                         "lasso")
    if args.problem not in ("logistic", "svm"):
        raise SystemExit(f"--density does not support {args.problem!r} "
                         f"(needs a separable ProxLoss on Dx)")
    loss, rho, tau, _ = _admm_params(args.problem)
    res = UnwrappedADMM(loss=loss, tau=tau, rho=rho, device=dev).run(
        bcsr, aux, iters=args.iters, obs=obs)
    return FitResult(res.x, int(res.iters), res.history.objective,
                     "transpose", args.problem)


def sparse_summary(problem, bcsr, a, x, mu):
    """The O(nnz) result line: everything needs only Dx and D^T r, in
    float64 on the data's device."""
    from repro_torch.kernels.spgram import ops as spgram_ops
    D64, x64, a64 = bcsr.astype(torch.float64), x.double(), a.double()
    Dx = spgram_ops.matvec(D64, x64)
    if problem == "lasso":
        grad = spgram_ops.rmatvec(D64, Dx - a64)
        on = x64.abs() > 1e-7
        viol = max(
            float((grad[on] + mu * torch.sign(x64[on])).abs().max())
            if bool(on.any()) else 0.0,
            float(torch.clamp(grad[~on].abs() - mu, min=0.0).max())
            if bool((~on).any()) else 0.0)
        return (f"KKT violation: {viol:.2e} (mu {mu:.6g}), support: "
                f"{int(on.sum())}")
    if problem == "logistic":
        zero = torch.zeros((), dtype=torch.float64, device=Dx.device)
        obj = float(torch.sum(torch.logaddexp(zero, -a64 * Dx)))
        acc = float(torch.mean((torch.sign(Dx) == a64).double()))
        return f"objective: {obj:.2f}, train acc: {acc:.4f}"
    obj = float(torch.sum(torch.clamp(1.0 - a64 * Dx, min=0.0))
                + 0.5 * torch.dot(x64, x64))
    return f"objective: {obj:.2f}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="logistic",
                    choices=["lasso", "logistic", "svm", "sparse_logistic"])
    ap.add_argument("--method", default="transpose",
                    choices=["transpose", "consensus", "fasta"])
    ap.add_argument("--executor", default=None,
                    choices=["local", "streaming", "shard_map", "cluster"],
                    help="solve topology: in-memory local (default), "
                         "out-of-core streaming, rows over the ranks of a "
                         "process group (shard_map), or worker processes "
                         "(cluster, --workers N) — all the same driver")
    ap.add_argument("--workers", type=int, default=2, metavar="N",
                    help="worker processes for --executor cluster")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--rows-per-node", type=int, default=5000)
    ap.add_argument("--features", type=int, default=200)
    ap.add_argument("--heterogeneous", action="store_true")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--mu", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the solve runs (default cuda; cpu on ask)")
    ap.add_argument("--density", type=float, default=None,
                    help="generate SPARSE data with this Bernoulli "
                         "density (0 < p <= 1); omit for dense")
    ap.add_argument("--sparse-format", default="blockcsr",
                    choices=["blockcsr", "dense"],
                    help="with --density: run the padded block-CSR path "
                         "(O(nnz) per pass) or densify for comparison")
    ap.add_argument("--streaming", action="store_true",
                    help="deprecated alias for --executor streaming")
    ap.add_argument("--multi-device", action="store_true",
                    help="deprecated alias for --executor shard_map")
    ap.add_argument("--device-budget-mb", type=int, default=256,
                    help="device-memory budget of the D blocks in flight "
                         "for --executor streaming")
    ap.add_argument("--store-dir", default=None,
                    help="persist the block store here (memory-mapped "
                         "reopen) instead of holding it in host RAM")
    ap.add_argument("--cluster", type=int, default=0, metavar="N",
                    help="deprecated alias for --executor cluster "
                         "--workers N")
    ap.add_argument("--cluster-compress", action="store_true",
                    help="int8 error-feedback compression on every "
                         "reduce hop (cluster path)")
    ap.add_argument("--cluster-staleness", type=int, default=0,
                    metavar="S",
                    help="bounded-staleness quorum aggregation: proceed "
                         "on a quorum, tolerate reductions up to S "
                         "iterations old (0 = strict synchronous)")
    ap.add_argument("--chaos-seed", type=int, default=None, metavar="S",
                    help="cluster path: inject a seeded, deterministic "
                         "fault schedule (worker kills/hangs, wire "
                         "delays/drops, a mid-solve join) generated from "
                         "this seed (DESIGN.md section 13)")
    ap.add_argument("--chaos-spec", default=None, metavar="SPEC",
                    help="cluster path: explicit fault schedule, e.g. "
                         "'kill@13:w2,delay@5:w0:80,join@9:w4' — "
                         "overrides --chaos-seed")
    ap.add_argument("--min-quorum", type=float, default=None, metavar="F",
                    help="graceful degradation: fraction of workers that "
                         "must stay reachable before the solve returns "
                         "best-so-far with status=degraded")
    ap.add_argument("--iter-deadline", type=float, default=None,
                    metavar="SEC",
                    help="graceful degradation: per-iteration collection "
                         "deadline; expired rounds are retried, then the "
                         "quorum is relaxed / the solve degrades")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="persist solver state here every "
                         "--checkpoint-every iterations (streaming and "
                         "cluster paths)")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest checkpoint in "
                         "--checkpoint-dir")
    ap.add_argument("--obs-dir", default=None,
                    help="write observability artifacts here: trace.json "
                         "(Perfetto), metrics.json, telemetry.jsonl "
                         "(summarize with repro_torch.launch.obs_report)")
    args = ap.parse_args(argv)

    if args.executor is None:
        if args.cluster:
            warnings.warn("--cluster N is deprecated; use --executor "
                          "cluster --workers N", DeprecationWarning,
                          stacklevel=2)
            args.executor = "cluster"
        elif args.streaming:
            warnings.warn("--streaming is deprecated; use --executor "
                          "streaming", DeprecationWarning, stacklevel=2)
            args.executor = "streaming"
        elif args.multi_device:
            warnings.warn("--multi-device is deprecated; use --executor "
                          "shard_map", DeprecationWarning, stacklevel=2)
            args.executor = "shard_map"
        else:
            args.executor = "local"
    if args.executor == "cluster" and not args.cluster:
        args.cluster = args.workers

    dev = resolve_device(args.device)
    # one Observability bundle per run: the cluster path hands the run
    # directory to the coordinator instead (it owns the merged trace), so
    # this process's bundle stays disabled there
    obs = Observability(
        dir=args.obs_dir if args.executor != "cluster" else None,
        process_name="fit")
    if args.executor == "shard_map":
        from repro_torch.sharding import compat
        # under torchrun, join first (a CUDA rank makes its data on its own
        # card) and leave the group at the end; alone, the world of one
        with compat.make_group(device=dev) as group, compat.use_group(group):
            return _run(args, dev, obs)
    return _run(args, dev, obs)


def _finish_obs(args, obs):
    obs.finish()
    if args.obs_dir:
        print(f"obs: wrote {args.obs_dir} (trace.json / metrics.json / "
              "telemetry.jsonl)", flush=True)


def _run(args, dev, obs):
    """Make the data, then ``_solve_and_report`` (or the sparse path)."""
    if args.density is not None:
        return _main_sparse(args, dev, obs)
    N, mi, n = args.nodes, args.rows_per_node, args.features
    het = 1.0 if args.heterogeneous else 0.0
    t0 = time.time()
    if args.problem == "lasso":
        prob = synthetic.lasso_problem(args.seed, N, mi, n,
                                       heterogeneity=het, device=dev)
        D, aux = prob.D, prob.b
        mu = args.mu if args.mu is not None else float(prob.mu)
    else:
        prob = synthetic.classification_problem(args.seed, N, mi, n,
                                                heterogeneity=het,
                                                device=dev)
        D, aux = prob.D, prob.labels
        mu = args.mu if args.mu is not None else 1.0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"data: {N} nodes x {mi} rows x {n} features "
          f"({N*mi*n*4/2**30:.2f} GiB) on {dev} in {time.time()-t0:.1f}s",
          flush=True)
    return _solve_and_report(args, D, aux, mu, dev, obs)


def _solve_and_report(args, D, aux, mu, dev, obs):
    """``fit()`` (or the out-of-core, shard_map or cluster fit) on
    node-stacked dense data, then the result lines."""
    n = D.shape[-1]
    t0 = time.time()
    if args.executor == "cluster":
        res = _fit_cluster(args, D, aux, mu, dev)
    elif args.executor == "streaming":
        res = _fit_streaming(args, D, aux, mu, dev, obs=obs)
    else:
        shard = args.executor == "shard_map" and \
            args.method == "transpose" and args.problem in ("logistic", "svm")
        # the ranks run in other processes: one span around them here, and
        # the objective history recorded afterwards, as for fit()
        with obs.span("fit_shard_map" if shard else "fit_glm",
                      problem=args.problem, method=args.method):
            if shard:
                res = _fit_shard_map(args, D, aux, dev)
            else:
                res = fit_glm(
                    args.problem, D, aux, method=args.method,
                    mu=mu if args.problem in ("lasso", "sparse_logistic")
                    else None, iters=args.iters, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        objective = getattr(res.objective_history, "tolist",
                            lambda: None)()
        if obs.enabled and isinstance(objective, list):
            for i, o in enumerate(objective):
                obs.record(iter=i + 1, objective=float(o))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    _finish_obs(args, obs)
    print(f"[{args.method}] {args.problem}: {res.iters} iters in {dt:.1f}s",
          flush=True)

    D2, a2 = D.reshape(-1, n), aux.reshape(-1)
    if args.problem == "lasso":
        viol, sup = lasso_kkt_gap(D2, a2, res.x, mu)
        print(f"KKT violation: {viol:.2e}, support err: {sup:.2e}")
    else:
        logi, hinge, acc = classifier_summary(D2, a2, res.x)
        if args.problem in ("logistic", "sparse_logistic"):
            print(f"objective: {logi:.2f}, train acc: {acc:.4f}")
        else:
            x64 = res.x.double()
            obj = hinge + 0.5 * float(torch.dot(x64, x64))
            print(f"objective: {obj:.2f}")
    return res


def _main_sparse(args, dev, obs):
    """``main`` for ``--density``: sparse data, then the block-CSR solve or
    the dense path on the densified matrix."""
    N, mi, n = args.nodes, args.rows_per_node, args.features
    m = N * mi
    t0 = time.time()
    if args.problem == "lasso":
        prob = sparse_data.sparse_lasso_problem(args.seed, m, n,
                                                args.density, device=dev)
        D, aux = prob.D, prob.b
        mu = args.mu if args.mu is not None else float(prob.mu)
    else:
        prob = sparse_data.sparse_classification_problem(
            args.seed, m, n, args.density, device=dev)
        D, aux = prob.D, prob.labels
        mu = args.mu if args.mu is not None else 1.0
    blockcsr = args.sparse_format == "blockcsr"
    gib = (D.nbytes if blockcsr else m * n * 4) / 2 ** 30
    print(f"data: {m} rows x {n} features at density {args.density} -> "
          f"{args.sparse_format} ({gib:.3f} GiB) on {dev} in "
          f"{time.time() - t0:.1f}s", flush=True)
    if not blockcsr:
        return _solve_and_report(args, D.to_dense().reshape(N, mi, n),
                                 aux.reshape(N, mi), mu, dev, obs)
    if args.executor == "cluster":
        raise SystemExit("--executor cluster currently takes dense data "
                         "(use --sparse-format dense)")
    t0 = time.time()
    res = (_fit_streaming if args.executor == "streaming"
           else _fit_sparse)(args, D, aux, mu, dev, obs=obs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _finish_obs(args, obs)
    print(f"[{args.method}] {args.problem}: {res.iters} iters in "
          f"{time.time() - t0:.1f}s", flush=True)
    print(sparse_summary(args.problem, D, aux, res.x, mu), flush=True)
    return res


if __name__ == "__main__":
    main()
