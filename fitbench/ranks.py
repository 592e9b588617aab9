"""Ranks for a cell on several chips: this process is rank 0 and starts
the others, one per chip, as new processes under ``spawn``. Each joins the
program's process group the way ``torchrun`` would describe it (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` at a free port of localhost)."""
from __future__ import annotations

import multiprocessing
import os
import socket

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
       "MASTER_ADDR", "MASTER_PORT")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(rank: int, world: int, port: int) -> dict:
    return {"RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def _child(fn, args, rank):
    fn(*args, rank=rank)


def run(world: int, fn, args, join_timeout: float = 120.0):
    """``fn(*args, rank=r)`` on ranks 1..world-1 in new processes and on
    rank 0 here; returns rank 0's result once every rank has ended. A rank
    that exits with an error fails the call."""
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    saved = {k: os.environ.get(k) for k in ENV}
    procs = []
    try:
        for r in range(1, world):
            os.environ.update(_env(r, world, port))
            p = ctx.Process(target=_child, args=(fn, args, r))
            p.start()
            procs.append(p)
        os.environ.update(_env(0, world, port))
        out = fn(*args, rank=0)
        for p in procs:
            p.join(timeout=join_timeout)
        bad = [(r + 1, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks (rank, exit code) {bad} failed")
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
