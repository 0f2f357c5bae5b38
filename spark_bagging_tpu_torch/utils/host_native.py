"""ctypes bridge to the host data loader (``native/loader.cpp``).

The port of the JAX package's ``utils/native.py`` under another name:
the port's ``utils/native.py`` builds the CUDA kernels. The shared
library is compiled with ``g++ -O2 -shared -fPIC -std=c++20`` at first
use into the gitignored ``spark_bagging_tpu_torch/_build/``, under a
file name that hashes the source and the flags, so an edited source is
rebuilt and a finished build is reused; nothing is built next to the
source. No pip or pybind dependency.

Every entry point degrades gracefully: where the toolchain or the
library is unavailable, callers fall back to the pure-Python parsers
in ``utils/datasets.py``, ``utils/io.py`` and ``utils/hashing.py``,
which give the same arrays. :data:`served` counts which path served
each read, so a caller can tell that the native path ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger(__name__)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "native", "loader.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++20")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False

#: reads served by each path since import
served = {"native": 0, "python": 0}


def note_served(path: str) -> None:
    """Count one read (a whole-file parse or a chunk stream) served by
    ``path``: "native" or "python"."""
    served[path] += 1


def library_path() -> str:
    """Where the build of the current source and flags lives."""
    h = hashlib.sha1(" ".join(GXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsbt_loader_{h.hexdigest()[:12]}.so")


def _build(path: str) -> bool:
    # compile to a process-unique temp path and rename atomically, so an
    # interrupted or concurrent build never leaves a truncated library
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, _SRC, "-o", tmp]
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=120
        )
        if proc.returncode != 0:
            log.info("host loader build failed:\n%s", proc.stderr)
            return False
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.TimeoutExpired) as e:
        log.info("host loader build skipped: %s", e)
        return False
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass


def _declare(lib: ctypes.CDLL) -> None:
    i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.svm_dims.argtypes = [ctypes.c_char_p, ctypes.c_int, i64p, i64p]
    lib.svm_dims.restype = ctypes.c_int
    lib.svm_fill.argtypes = [
        ctypes.c_char_p, ctypes.c_int, i64, i64, f32p, f32p,
    ]
    lib.svm_fill.restype = ctypes.c_int
    lib.csv_dims.argtypes = [ctypes.c_char_p, ctypes.c_int, i64p, i64p]
    lib.csv_dims.restype = ctypes.c_int
    lib.csv_fill.argtypes = [
        ctypes.c_char_p, ctypes.c_int, i64, i64, i64, f32p, f32p,
    ]
    lib.csv_fill.restype = ctypes.c_int
    lib.reader_open_svm.argtypes = [ctypes.c_char_p, i64, ctypes.c_int]
    lib.reader_open_svm.restype = ctypes.c_void_p
    lib.reader_open_csv.argtypes = [ctypes.c_char_p, i64, i64, ctypes.c_int]
    lib.reader_open_csv.restype = ctypes.c_void_p
    lib.reader_open_csv_hashed.argtypes = [
        ctypes.c_char_p, i64, i64p, i64, i64p, i64, i64, i64,
        ctypes.c_char, ctypes.c_int,
    ]
    lib.reader_open_csv_hashed.restype = ctypes.c_void_p
    lib.csv_count_rows.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.csv_count_rows.restype = i64
    lib.reader_next.argtypes = [ctypes.c_void_p, i64, f32p, f32p]
    lib.reader_next.restype = i64
    lib.reader_close.argtypes = [ctypes.c_void_p]
    lib.reader_close.restype = None


def get_lib() -> ctypes.CDLL | None:
    """The loaded host library, building it if needed; None if the
    native path is unavailable (callers must fall back)."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            path = library_path()
            if not os.path.exists(path) and not _build(path):
                _load_failed = True
                return None
            lib = ctypes.CDLL(path)
            _declare(lib)
            _lib = lib
        except OSError as e:
            log.info("host loader unavailable: %s", e)
            _load_failed = True
    return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


_ERR_NUL = -4


def _nul_fallback(path: str) -> None:
    """An embedded NUL byte ended the native parse: the C parsers work
    on NUL-terminated line buffers and would otherwise silently
    truncate rows, diverging from the Python fallback. Warn and hand
    the file to the Python parsers instead."""
    import warnings

    warnings.warn(
        f"{path} contains an embedded NUL byte; falling back to the "
        "Python parser for this file", stacklevel=3,
    )


def parse_libsvm_native(
    path: str, n_features: int | None = None, zero_based: bool = False
) -> tuple[np.ndarray, np.ndarray] | None:
    """Native libsvm parse; None if the library is unavailable (or the
    file needs the Python fallback's handling)."""
    lib = get_lib()
    if lib is None:
        return None
    rows, maxf = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.svm_dims(
        path.encode(), int(zero_based), ctypes.byref(rows),
        ctypes.byref(maxf),
    )
    if rc == _ERR_NUL:
        _nul_fallback(path)
        return None
    if rc != 0:
        raise OSError(f"native svm_dims failed ({rc}) for {path}")
    d = n_features if n_features is not None else int(maxf.value)
    if d <= 0:
        # label-only file: svm_fill rejects n_features <= 0, but the
        # Python fallback loads it as (n, 0): degrade the same way
        return None
    X = np.zeros((int(rows.value), d), np.float32)
    y = np.zeros((int(rows.value),), np.float32)
    rc = lib.svm_fill(
        path.encode(), int(zero_based), rows.value, d, _fptr(X), _fptr(y)
    )
    if rc == _ERR_NUL:
        _nul_fallback(path)
        return None
    if rc != 0:
        raise ValueError(f"native svm_fill failed ({rc}) for {path}")
    return X, y


def load_csv_native(
    path: str, *, label_col: int = -1, skip_header: bool = False
) -> tuple[np.ndarray, np.ndarray] | None:
    """Native CSV parse; None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.csv_dims(
        path.encode(), int(skip_header), ctypes.byref(rows),
        ctypes.byref(cols),
    )
    if rc == _ERR_NUL:
        _nul_fallback(path)
        return None
    if rc != 0:
        raise OSError(f"native csv_dims failed ({rc}) for {path}")
    n, c = int(rows.value), int(cols.value)
    X = np.empty((n, c - 1), np.float32)
    y = np.empty((n,), np.float32)
    rc = lib.csv_fill(
        path.encode(), int(skip_header), int(label_col), n, c,
        _fptr(X), _fptr(y),
    )
    if rc == _ERR_NUL:
        _nul_fallback(path)
        return None
    if rc != 0:
        raise ValueError(f"native csv_fill failed ({rc}) for {path}")
    return X, y


class NativeReader:
    """Streaming block reader over the native library.

    Yields ``(X, y)`` blocks of at most ``block_rows`` rows; used by the
    chunk sources in ``utils/io.py`` when the library is available.
    """

    def __init__(self, handle: int, n_features: int, block_rows: int):
        self._h = handle
        self._n_features = n_features
        self._block_rows = block_rows

    @classmethod
    def open_svm(
        cls, path: str, n_features: int, block_rows: int,
        *, zero_based: bool = False,
    ) -> "NativeReader | None":
        lib = get_lib()
        if lib is None:
            return None
        h = lib.reader_open_svm(path.encode(), n_features, int(zero_based))
        if not h:
            raise OSError(f"cannot open {path}")
        return cls(h, n_features, block_rows)

    @classmethod
    def open_csv_hashed(
        cls, path: str, block_rows: int,
        *, label_col: int, numeric_cols: list[int],
        categorical_cols: list[int], n_hash: int, seed: int = 0,
        delimiter: str = ",", skip_header: bool = False,
    ) -> "NativeReader | None":
        """Streaming hashed-CSV reader (fmt 2 in loader.cpp): numeric
        passthrough + signed feature hashing, bit-identical to the
        Python FeatureHasher (same crc32 tokens). Returns None when the
        native library is unavailable OR the spec needs the Python path
        (multi-char delimiter, negative column indices)."""
        if (
            len(delimiter.encode()) != 1  # byte count: ctypes.c_char
            or label_col < 0
            or any(c < 0 for c in numeric_cols + categorical_cols)
        ):
            return None
        lib = get_lib()
        if lib is None:
            return None
        num = (ctypes.c_int64 * max(1, len(numeric_cols)))(*numeric_cols)
        cat = (ctypes.c_int64 * max(1, len(categorical_cols)))(
            *categorical_cols
        )
        h = lib.reader_open_csv_hashed(
            path.encode(), label_col, num, len(numeric_cols), cat,
            len(categorical_cols), n_hash, seed,
            delimiter.encode(), int(skip_header),
        )
        if not h:
            raise OSError(f"cannot open {path} (or invalid hashed spec)")
        n_features = len(numeric_cols) + (
            n_hash if categorical_cols else 0
        )
        return cls(h, n_features, block_rows)

    @classmethod
    def open_csv(
        cls, path: str, n_cols: int, block_rows: int,
        *, label_col: int = -1, skip_header: bool = False,
    ) -> "NativeReader | None":
        lc = label_col + n_cols if label_col < 0 else label_col
        if n_cols < 2 or lc < 0 or lc >= n_cols:
            raise ValueError(
                f"label_col {label_col} out of range for {n_cols} columns"
            )
        lib = get_lib()
        if lib is None:
            return None
        h = lib.reader_open_csv(
            path.encode(), n_cols, label_col, int(skip_header)
        )
        if not h:
            raise OSError(f"cannot open {path}")
        return cls(h, n_cols - 1, block_rows)

    def __iter__(self):
        lib = get_lib()
        try:
            while True:
                X = np.zeros(
                    (self._block_rows, self._n_features), np.float32
                )
                y = np.zeros((self._block_rows,), np.float32)
                got = lib.reader_next(
                    self._h, self._block_rows, _fptr(X), _fptr(y)
                )
                if got == _ERR_NUL:
                    raise ValueError(
                        "native reader hit an embedded NUL byte "
                        "mid-stream; re-open the source with the "
                        "Python parser (e.g. remove NULs, or use the "
                        "fallback path)"
                    )
                if got < 0:
                    raise ValueError(f"native reader_next failed ({got})")
                if got == 0:
                    return
                yield X[:got], y[:got]
        finally:
            self.close()

    def close(self):
        if self._h:
            get_lib().reader_close(self._h)
            self._h = None
