"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface and loaded with ``ctypes``. Nothing is
built when the package is imported: the first kernel launch builds,
into ``spark_bagging_tpu_torch/_build/`` (listed in ``.gitignore``).
The library's file name carries a hash of the sources and flags, so an
edited source is rebuilt and a finished build is reused. A build that
fails raises with the compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: facts about the build this process loaded: path, seconds, compiler log
build_info: dict = {}


def _defines() -> list[str]:
    """Compile-time constants that the Python wrappers own (each
    kernel's tiling), as nvcc ``-D`` flags: stated once, in the wrapper
    that also computes the launch geometry from them."""
    from spark_bagging_tpu_torch.ops import gram, hist

    defines = {**gram.CUDA_DEFINES, **hist.CUDA_DEFINES}
    return [f"-D{k}={v}" for k, v in sorted(defines.items())]


def _flags() -> list[str]:
    return [*NVCC_FLAGS, *_defines()]


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        f"{CSRC_DIR} at first use"
    )


def library_path() -> str:
    """Where the build of the current sources lives."""
    h = hashlib.sha1(" ".join(_flags()).encode())
    for src in _sources() + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libsbt_kernels_{h.hexdigest()[:12]}.so")


def _run(cmds: list[list[str]]) -> str:
    """Run the commands concurrently; raise with the compiler's output if
    any fails. Returns their combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=900)
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
    finally:  # a timeout or interrupt leaves no compiler running
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(logs)


def build() -> str:
    """Compile ``csrc/*.cu`` unless a build of these sources exists;
    returns the library path. Each source compiles in its own nvcc,
    all started together, then one link. Records seconds and the
    compiler's ``-Xptxas -v`` report in :data:`build_info`."""
    path = library_path()
    if os.path.exists(path):
        build_info.update(path=path, seconds=0.0, log="(cached)")
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    # process-unique temp names + atomic rename: a concurrent or cut
    # build never leaves a truncated library behind
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            for src in _sources()]
    tmp = f"{path}.{tag}"
    t0 = time.perf_counter()
    try:
        log = _run([[nvcc, *_flags(), "-c", "-o", obj, src]
                    for src, obj in zip(_sources(), objs)])
        log += _run([[nvcc, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, path)
    finally:
        for f in (*objs, tmp):
            if os.path.exists(f):
                os.unlink(f)
    build_info.update(path=path, seconds=time.perf_counter() - t0,
                      log=log.strip())
    return path


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sbt_scaled_gram.argtypes = [
        vp, i64, vp, vp, vp,               # X, x_rstride, S, out, partials
        i32, i32, i32, i32,                # n, d, P, R
        i32, i32, i32, i32, i32, i32,      # n_x pg groups nt splits rows
        i32, vp,                           # bf16, stream
    ]
    lib.sbt_scaled_gram.restype = i32
    lib.sbt_gram_mma_probe.argtypes = [vp, vp, vp, vp, i32, vp]
    lib.sbt_gram_mma_probe.restype = i32
    lib.sbt_bin_codes.argtypes = [
        vp, i64, vp, i64, vp,              # X, x_rstride, E, e_rstride, codes
        i64, i32, i32, i32,                # n, F, B, R
        i32, i32, vp,                      # code_bytes, blocks, stream
    ]
    lib.sbt_bin_codes.restype = i32
    lib.sbt_binned_left_stats.argtypes = [
        vp, i64, i32, i32, vp,             # codes, c_rstride, c_row, bytes, cols
        vp, i64,                           # edges, e_rstride
        vp, vp, vp, vp,                    # node, S, out, partials
        i32, i32, i32, i32, i32, i32, i32,  # n, F, B, b0, N, K, R
        i32, i32, i32, i32,                # f_tile n_tile f_tiles n_tiles
        i32, i32,                          # b_stride cap
        i32, i32, i32,                     # splits rows_per_split smem
        i32, i32, vp,                      # bf16, integral, stream
    ]
    lib.sbt_binned_left_stats.restype = i32
    lib.sbt_cuda_error_string.argtypes = [i32]
    lib.sbt_cuda_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _declare(lib)
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.sbt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
