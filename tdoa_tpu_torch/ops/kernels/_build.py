"""Build and load the hand-written Hopper kernels.

Every ``*.cu`` under ``tdoa_tpu_torch/csrc/`` compiles with its own
``nvcc`` process (all started together) and the objects link into ONE
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so the build takes seconds, not minutes). The build
happens at first use, from the checkout's sources only, into
``build/tdoa_tpu_torch/<hash of the sources and flags>/`` at the
repository root — a directory ``.gitignore`` lists. A file lock
serializes concurrent builds (parallel test workers on one card);
a finished library is reused by every later process.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

PKG_DIR = Path(__file__).resolve().parents[2]  # tdoa_tpu_torch/
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "tdoa_tpu_torch"
LIB_NAME = "libtdoa_kernels.so"

# sm_90a keeps the Hopper-only instructions available; no fast-math:
# the zoom probe's basis angles reach ~50 rad, where __sinf is wrong,
# and the FM discriminator wants the accurate atan2f.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None
_lib_defines: tuple = ()


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _flags(defines: Sequence[str]) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _digest(flags: tuple) -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return cand


def build(defines: Sequence[str] = ()) -> Path:
    """Compile the library unless this source hash is already built;
    returns its path. ``defines`` are preprocessor macros of the build
    (``TDOA_TIMELINE`` compiles the kernels' timeline stamps). The ptxas
    report (registers, shared memory, spills per kernel) is kept beside
    it as ``ptxas.txt``."""
    flags = _flags(defines)
    out_dir = BUILD_ROOT / _digest(flags)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists():  # another process built it while we waited
                return lib
            nvcc = nvcc_path()
            jobs = []
            for src in sorted(CSRC_DIR.glob("*.cu")):
                obj = out_dir / f"{src.stem}.o"
                cmd = [nvcc, *flags, f"-I{CSRC_DIR}", "-c", "-o",
                       str(obj), str(src)]
                jobs.append((cmd, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            report, failed = [], []
            for cmd, _, proc in jobs:
                out, _ = proc.communicate()
                report.append(out)
                if proc.returncode != 0:
                    failed.append(f"nvcc failed ({proc.returncode}):\n"
                                  f"{' '.join(cmd)}\n{out}")
            (out_dir / "ptxas.txt").write_text("".join(report))
            if failed:
                raise RuntimeError("\n".join(failed))
            tmp = out_dir / (LIB_NAME + f".tmp{os.getpid()}")
            cmd = [nvcc, "-shared", "-o", str(tmp),
                   *(str(obj) for _, obj, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}"
                    f"\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tdoa_corr_accum.argtypes = [
        p, p, i,            # x re, x im, input is bf16
        ctypes.c_longlong,  # station stride (elements)
        i,                  # n_st
        p, i,               # pairs [m, 2] int32 (device), m
        i, i,               # n_banks, track_sums
        p, i,               # slot plan [n_banks*run] int32, run
        i,                  # reuse stage 1
        p,                  # scratch [n_st, n_banks*run, F] float2
        p, p, p,            # cross float2 [K, m, F], psd [K, n_st, F], sums float2
        p,                  # stream
    ]
    lib.tdoa_corr_accum.restype = i
    lib.tdoa_corr_accum_config.argtypes = [i, i, i, i, p]  # n_st, m, track, bf16, out[4]
    lib.tdoa_corr_accum_config.restype = i
    lib.tdoa_zoom_probe.argtypes = [
        p, p,               # cross_g float2 [K, m, F], psd_g [K, n_st, F]
        p, p, p,            # pairs [m, 2] int32, coarse [m] f32, nseg [K*m] f32
        i, i, i, i,         # K, m, n_st, F
        ctypes.c_float,     # eps
        p, p, p, p,         # per-bin scratch float4, chunk sums, chunk windows, barrier
        p,                  # out window float2 [K*m, W]
        p,                  # stream
    ]
    lib.tdoa_zoom_probe.restype = i
    lib.tdoa_fm_demod.argtypes = [
        p, p,               # x re, x im rows (f32)
        ctypes.c_longlong,  # channel stride (elements)
        i,                  # C channels
        ctypes.c_longlong,  # n samples per channel
        i,                  # decim
        ctypes.c_double,    # sample rate (with decim, the key of the taps)
        ctypes.c_float,     # fs / (2*pi*dev)
        p, i,               # taps [128] f32 (host), rows 16-byte aligned
        p,                  # out [C, n / decim] f32
        p,                  # stream
    ]
    lib.tdoa_fm_demod.restype = i
    lib.tdoa_lm_solve.argtypes = [
        p,                  # in: [m] pairs as 2 float4, then [S] starts float4
        i, i, i, i,         # m, S, n_dim, iters
        p,                  # out float4 [S]: x, y, z, rms
        p,                  # stream
    ]
    lib.tdoa_lm_solve.restype = i


def load(defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded kernel library, built on the first call in a process
    with that call's ``defines`` (see ``build``). A process holds one
    build: later calls without ``defines`` return it, a call with other
    ``defines`` raises."""
    global _lib, _lib_defines
    defines = tuple(defines)
    if _lib is None:
        lib = ctypes.CDLL(str(build(defines)))
        _declare(lib)
        _lib, _lib_defines = lib, defines
    elif defines and defines != _lib_defines:
        raise RuntimeError(f"the kernel library is loaded with defines "
                           f"{_lib_defines}, not {defines}")
    return _lib
