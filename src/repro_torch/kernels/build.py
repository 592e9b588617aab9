"""Build and load the port's CUDA kernels (K1 prox, K2 gram, K3 admm_iter,
K4 flash_attn and flash_attn_sm90, K5 wkv, K6 spgram).

The sources in ``csrc/`` have a plain C interface. ``library()`` compiles
them with one ``nvcc -c`` per source, all started together, links the
objects into a shared library under ``build/repro_torch/`` at the root of
the checkout, named by a hash of the sources and flags, and loads it with
``ctypes``. A second call in the same process, or a later
process that finds the library already built, skips the compiler.

Flags: ``-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
-fPIC`` and deliberately no ``--use_fast_math``: the logistic
prox bisects on the sign of phi' near its root, so expf and division stay
IEEE. Every C entry point returns ``cudaGetLastError()``; :func:`check`
raises on anything but 0. Nothing here catches a build or launch error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("prox.cu", "gram.cu", "admm_iter.cu", "flash_attn.cu",
           "flash_attn_sm90.cu", "wkv.cu", "spgram.cu")
HEADERS = ("prox.cuh",)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# name -> argtypes; every function returns a cudaError_t as int
SIGNATURES = {
    "repro_prox_update": (_P, _P, _P, _P, _P, _LL, _I, _F, _I, _F, _I, _P),
    "repro_gram": (_P, _I, _P, _LL, _I, _I, _I, _LL, _I, _P, _P, _P, _P,
                   _I, _I, _P),
    "repro_admm_iter": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I,
                        _LL, _I, _I, _F, _F, _P),
    "repro_admm_iter_ring": (_P, _I) + (_P,) * 8 + (_LL, _I, _LL, _I, _I,
                                                      _I, _I, _I, _F, _F, _P),
    "repro_flash_attn": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I)
    + (_LL,) * 12 + (_F, _I, _P),
    "repro_flash_attn_tc": (_P,) * 4 + (_I,) * 6 + (_LL,) * 12 + (_F, _I, _P),
    "repro_wkv": (_P,) * 7 + (_I,) * 6 + (_LL,) * 15 + (_F, _P),
    "repro_spgram_iter": (_P,) * 4 + (_I,) + (_P,) * 8 + (_LL,) + (_I,) * 6
    + (_F, _F, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build(out_dir: Path = BUILD_DIR) -> Path:
    """Compile the sources into ``out_dir`` unless the hashed library is
    already there; returns its path. Raises on a compiler error."""
    out = out_dir / f"librepro_torch_{source_hash()}.so"
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp_dir = Path(tempfile.mkdtemp(dir=out_dir))
    objs = [tmp_dir / f"{Path(s).stem}.o" for s in SOURCES]
    cmds = [[nvcc(), *FLAGS, "-c", "-o", str(o), str(CSRC / s)]
            for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    runs = [(c, p.returncode, *o) for c, p, o in zip(cmds, procs, outs)]
    lib = tmp_dir / "lib.so"
    link = [nvcc(), "-shared", "-o", str(lib), *map(str, objs)]
    if all(rc == 0 for _, rc, _, _ in runs):
        proc = subprocess.run(link, capture_output=True, text=True)
        runs.append((link, proc.returncode, proc.stdout, proc.stderr))
    failed = [r for r in runs if r[1] != 0]
    if failed:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        cmd, rc, so, se = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{so}{se}")
    os.replace(lib, out)          # atomic: a concurrent builder loses nothing
    shutil.rmtree(tmp_dir, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = (ctypes.c_int,)
            lib.repro_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, what: str):
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = library().repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(t) -> int:
    """The current PyTorch stream of ``t``'s device, as a pointer."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()
