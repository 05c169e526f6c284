"""ctypes bindings for the host-side canonicalization kernels and the
threaded problem-bank IO (JAX counterpart: qcqp_tpu/native/__init__.py).

The C++ source is the port's own copy, `canon.cc` beside this file (the
JAX package's `qcqp_tpu/native/canon.cc` as it was copied), built with g++
at first use into the port's build directory, keyed by a hash of the
source.  Where g++ is missing or fails, numpy computes the same sums and
the bank goes through an `.npz` file, as in the JAX package: this is host
work, not device work.  A bank written by either package loads in the
other, natively or through `.npz`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "canon.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")


class _Lib:
    """The loaded library, or None once a build attempt has failed."""
    tried = False
    lib: Optional[ctypes.CDLL] = None


def _build() -> Optional[str]:
    if not os.path.exists(_SRC):
        return None
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_BUILD_DIR, f"libqcqpnative-{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
           "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        os.unlink(tmp)
        return None
    os.replace(tmp, out)     # atomic: concurrent processes agree on one file
    return out


def _load() -> Optional[ctypes.CDLL]:
    if _Lib.tried:
        return _Lib.lib
    _Lib.tried = True
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    dp = ctypes.POINTER(ctypes.c_double)
    i8p = ctypes.POINTER(ctypes.c_int8)
    i64 = ctypes.c_int64
    lib.qn_square_accumulate.argtypes = [dp, dp, i64, i64, ctypes.c_double,
                                         dp, dp, dp]
    lib.qn_square_accumulate.restype = None
    lib.qn_mul_accumulate.argtypes = [dp, dp, dp, dp, i64, i64,
                                      ctypes.c_double, dp, dp, dp]
    lib.qn_mul_accumulate.restype = None
    lib.qn_bank_write.restype = i64
    lib.qn_bank_write.argtypes = [ctypes.c_char_p, i64, i64, i64, dp, dp, dp,
                                  i8p]
    lib.qn_bank_info.restype = i64
    lib.qn_bank_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(i64),
                                 ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.qn_bank_load.restype = i64
    lib.qn_bank_load.argtypes = [ctypes.c_char_p, i64, i64, dp, dp, dp, i8p]
    _Lib.lib = lib
    return lib


def available() -> bool:
    """Whether the native library is built (or builds now)."""
    return _load() is not None


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _i8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def _check_out(P, q, r, s, n):
    for a, shape in ((P, (s, n, n)), (q, (s, n)), (r, (s,))):
        if (a.dtype != np.float64 or a.shape != shape
                or not a.flags["C_CONTIGUOUS"]):
            raise ValueError(f"output must be C-contiguous float64 {shape}")


def square_accumulate(C: np.ndarray, d: np.ndarray, w: float,
                      P: np.ndarray, q: np.ndarray, r: np.ndarray) -> None:
    """P[j] += w c_j c_j^T; q[j] += 2 w d_j c_j; r[j] += w d_j^2 (in place)."""
    s, n = C.shape
    lib = _load() if s * n * n >= 1 << 16 else None
    if lib is not None:
        _check_out(P, q, r, s, n)
        C = np.ascontiguousarray(C, np.float64)
        d = np.ascontiguousarray(d, np.float64)
        lib.qn_square_accumulate(_dp(C), _dp(d), s, n, float(w),
                                 _dp(P), _dp(q), _dp(r))
        return
    P += w * (C[:, :, None] * C[:, None, :])
    q += 2.0 * w * d[:, None] * C
    r += w * d * d


def mul_accumulate(Ca, da, Cb, db, w, P, q, r) -> None:
    """P[j] += w sym(a_j b_j^T); q[j] += w (da_j b_j + db_j a_j);
    r[j] += w da_j db_j (in place)."""
    s, n = Ca.shape
    lib = _load() if s * n * n >= 1 << 16 else None
    if lib is not None:
        _check_out(P, q, r, s, n)
        Ca = np.ascontiguousarray(Ca, np.float64)
        Cb = np.ascontiguousarray(Cb, np.float64)
        da = np.ascontiguousarray(da, np.float64)
        db = np.ascontiguousarray(db, np.float64)
        lib.qn_mul_accumulate(_dp(Ca), _dp(da), _dp(Cb), _dp(db), s, n,
                              float(w), _dp(P), _dp(q), _dp(r))
        return
    P += 0.5 * w * (Ca[:, :, None] * Cb[:, None, :]
                    + Cb[:, :, None] * Ca[:, None, :])
    q += w * (da[:, None] * Cb + db[:, None] * Ca)
    r += w * da * db


# ---------------------------------------------------------------------------
# Problem-bank IO (with numpy .npz fallback).  Layout (canon.cc): a header
# {magic, version, count, n, m} of int64, then per instance P (m+1, n, n),
# q (m+1, n), r (m+1,) in float64 and is_eq (m,) in int8.
# ---------------------------------------------------------------------------

def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def bank_write(path: str, P: np.ndarray, q: np.ndarray, r: np.ndarray,
               is_eq: np.ndarray) -> None:
    """Write a batch of instances: P (count, m+1, n, n), q, r, is_eq.
    Without the library, an .npz file at `path` (+ ".npz")."""
    count, k, n, _ = P.shape
    lib = _load()
    if lib is None:
        np.savez(path, P=P, q=q, r=r, is_eq=is_eq)
        return
    P = np.ascontiguousarray(P, np.float64)
    q = np.ascontiguousarray(q, np.float64)
    r = np.ascontiguousarray(r, np.float64)
    eq = np.ascontiguousarray(np.asarray(is_eq).astype(np.int8))
    rc = lib.qn_bank_write(path.encode(), count, n, k - 1, _dp(P), _dp(q),
                           _dp(r), _i8p(eq))
    if rc != 0:
        raise IOError(f"qn_bank_write failed: {rc}")


def bank_info(path: str) -> Tuple[int, int, int]:
    """(count, n, m) of a bank."""
    lib = _load()
    if lib is None:
        with np.load(_npz(path)) as z:
            c, k, n, _ = z["P"].shape
            return c, n, k - 1
    c, n, m = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    rc = lib.qn_bank_info(path.encode(), ctypes.byref(c), ctypes.byref(n),
                          ctypes.byref(m))
    if rc != 0:
        raise IOError(f"qn_bank_info failed: {rc}")
    return c.value, n.value, m.value


def bank_load(path: str, start: int, batch: int):
    """Instances [start, start+batch) as stacked host arrays (P, q, r in
    float64, is_eq bool), read by up to 8 threads."""
    lib = _load()
    if lib is None:
        with np.load(_npz(path)) as z:
            sl = slice(start, start + batch)
            return (z["P"][sl], z["q"][sl], z["r"][sl],
                    z["is_eq"][sl].astype(bool))
    _, n, m = bank_info(path)
    k = m + 1
    P = np.empty((batch, k, n, n), np.float64)
    q = np.empty((batch, k, n), np.float64)
    r = np.empty((batch, k), np.float64)
    eq = np.empty((batch, m), np.int8)
    rc = lib.qn_bank_load(path.encode(), start, batch, _dp(P), _dp(q), _dp(r),
                          _i8p(eq))
    if rc != 0:
        raise IOError(f"qn_bank_load failed: {rc}")
    return P, q, r, eq.astype(bool)
