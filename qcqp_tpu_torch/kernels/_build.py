"""Build and load the port's CUDA kernels (no JAX counterpart: the Pallas
kernels are compiled by JAX itself).

The sources in `qcqp_tpu_torch/csrc/` are compiled by nvcc, at first use,
one nvcc process per source, all started together, and linked into one
shared library with a plain C interface, which ctypes loads.  The
library lands in the package's `build/` directory (listed in .gitignore)
under a name keyed by a hash of the sources, so a checkout builds it once
and a changed source builds anew.  Flags:

    -gencode arch=compute_90a,code=sm_90a   Hopper (H100)
    -fmad=false                             no contracted multiply-add, and
                                            no --use_fast_math: sqrtf and
                                            division stay IEEE, as the
                                            kernels' slop constants assume

Nothing here runs at import: `library()` builds on its first call, which
only a wrapper handed a CUDA tensor makes.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points and their argument types (see csrc/*.cu).
_SIGNATURES = {
    "qk_phase1_update": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I,
                         _I, _F, _F, _I, _I, _I, _I, _P],
    "qk_cd_sweeps": [_P] * 6 + [_I, _P] + [_I] * 5 + [_F, _F] + [_I] * 5
                    + [_P],
    "qk_admm_phase": [_P] * 13 + [_I] * 5 + [_F] * 5 + [_I] * 4 + [_P],
    "qk_ccp_improve": [_P] * 17 + [_I] * 8 + [_F] * 8 + [_P],
    "qk_eigh_jacobi": [_P] * 6 + [_I] * 7 + [_P],
}


class BuildInfo:
    """What the one build of this process did: the library path, the
    seconds nvcc took (0.0 when the library was already built) and the
    compiler's report (registers and spills per kernel, from -Xptxas -v)."""
    path: Optional[str] = None
    seconds: float = 0.0
    log: str = ""


class _Loaded:
    lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the qcqp_tpu_torch CUDA kernels are built from "
            "source at first use on a machine with the CUDA toolkit")
    return nvcc


def _build() -> str:
    out = os.path.join(BUILD_DIR, f"libqcqp_cuda-{_digest()}.so")
    BuildInfo.path = out
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    t0 = time.perf_counter()
    try:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
        lib = os.path.join(work, "lib.so")
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib, *objs]
        if all(rc == 0 for _, _, rc in logs):
            proc = subprocess.run(link, capture_output=True, text=True)
            logs.append((link, proc.stdout + proc.stderr, proc.returncode))
        BuildInfo.seconds = time.perf_counter() - t0
        BuildInfo.log = "".join(log for _, log, _ in logs)
        for cmd, log, rc in logs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n"
                                   f"{log}")
        os.replace(lib, out)  # atomic: concurrent processes agree on a file
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on the first call."""
    if _Loaded.lib is None:
        lib = ctypes.CDLL(_build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _Loaded.lib = lib
    return _Loaded.lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned after a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
