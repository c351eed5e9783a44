"""Native (C++) runtime components, bound over ctypes.

Currently: ``fastcsv`` — the multithreaded numeric-CSV parser behind the
on-disk dataset readers (:mod:`egc_tpu.data.ondisk`). The shared library is
compiled lazily with g++ on first use and cached next to the source (or in
``$EGC_NATIVE_CACHE`` when the package directory is read-only); every
caller falls back to pandas / numpy when no compiler is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC_DIR = Path(__file__).parent
_LOCK = threading.Lock()
_LIB = None
_LIB_TRIED = False


def _cache_dir() -> Path:
    env = os.environ.get("EGC_NATIVE_CACHE")
    if env:
        return Path(env)
    return _SRC_DIR


def _build(src: Path, out: Path) -> bool:
    base = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
            str(src), "-o", str(out), "-lpthread"]
    # -march=native first; retry portable flags on ANY failure (nonzero
    # rc, missing compiler, timeout)
    for extra in (["-march=native"], []):
        cmd = base[:2] + extra + base[2:]
        try:
            res = subprocess.run(cmd, capture_output=True, timeout=120)
            if res.returncode == 0 and out.exists():
                return True
        except (OSError, subprocess.TimeoutExpired):
            continue
    return False


def get_fastcsv() -> Optional[ctypes.CDLL]:
    """The fastcsv library, building it on first call; None if unavailable."""
    global _LIB, _LIB_TRIED
    with _LOCK:
        if _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        src = _SRC_DIR / "fastcsv.cpp"
        if not src.exists():
            return None
        so = _cache_dir() / "fastcsv.so"
        # content-hash staleness check: mtimes are unreliable across git
        # clones/checkouts, and a binary built elsewhere (-march=native)
        # must never be dlopened on this host
        sha = hashlib.sha256(src.read_bytes()).hexdigest()
        sha_file = Path(str(so) + ".sha")
        fresh = (so.exists() and sha_file.exists()
                 and sha_file.read_text().strip() == sha)
        if not fresh:
            try:
                so.parent.mkdir(parents=True, exist_ok=True)
            except OSError:
                return None
            tmp = so.with_suffix(".so.tmp%d" % os.getpid())
            try:
                if not _build(src, tmp):
                    return None
                os.replace(tmp, so)
                sha_file.write_text(sha)
            finally:
                tmp.unlink(missing_ok=True)
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.fastcsv_count.restype = ctypes.c_int64
        lib.fastcsv_count.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.fastcsv_check_rows.restype = ctypes.c_int64
        lib.fastcsv_check_rows.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                           ctypes.c_int64]
        for name, ctype in (("fastcsv_parse_f32", ctypes.c_float),
                            ("fastcsv_parse_f64", ctypes.c_double),
                            ("fastcsv_parse_i64", ctypes.c_int64)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                           ctypes.POINTER(ctype), ctypes.c_int64]
        _LIB = lib
        return _LIB


_PARSERS = {
    np.dtype(np.float32): ("fastcsv_parse_f32", ctypes.c_float),
    np.dtype(np.float64): ("fastcsv_parse_f64", ctypes.c_double),
    np.dtype(np.int64): ("fastcsv_parse_i64", ctypes.c_int64),
}


def csv_rows_consistent(data: bytes, cols: int) -> Optional[int]:
    """Number of non-empty CSV rows when EVERY row has exactly ``cols``
    fields (native per-row check, same separator set as the parser);
    -1 when any row disagrees; None when the library is unavailable."""
    lib = get_fastcsv()
    if lib is None:
        return None
    return int(lib.fastcsv_check_rows(data, len(data), int(cols)))


def parse_csv_bytes(data: bytes, dtype) -> Optional[np.ndarray]:
    """Parse decompressed CSV text into a flat typed array via the native
    parser; None if the library is unavailable or dtype unsupported."""
    dtype = np.dtype(dtype)
    key = dtype if dtype in _PARSERS else np.dtype(np.int64) \
        if dtype.kind in "iu" else np.dtype(np.float64) \
        if dtype.kind == "f" else None
    if key is None:
        return None
    lib = get_fastcsv()
    if lib is None:
        return None
    n = lib.fastcsv_count(data, len(data))
    if n < 0:
        return None
    fn_name, ctype = _PARSERS[key]
    out = np.empty(n, key)
    got = getattr(lib, fn_name)(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctype)), n)
    if got != n:
        return None
    return out.astype(dtype, copy=False)
