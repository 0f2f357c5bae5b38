"""The seam between the port's kernel wrappers and their CUDA library.

:data:`KERNELS` names the wrapper modules. Each states its kernel's
nvcc defines (``CUDA_DEFINES``), the ctypes signatures of the ``sbt_*``
functions it calls (``declare(lib)``, beside the calls) and its launch
counters by report key (``LAUNCH_COUNTERS``, ``key: (wrapper,
attribute)``). All sources build into one library (utils/native.py),
so the first launch of any kernel builds with every define and
declares every function. The wrappers' shared scaffold is here too.
"""

from __future__ import annotations

import ctypes
import importlib
import threading
from typing import Callable

import torch

from spark_bagging_tpu_torch.utils import native

KERNELS = ("gram", "hist", "soft_vote", "tree_vote")

# ctypes argument types of the C interface
VP, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_ready_devices: set[tuple[str, int]] = set()
_library: torch.library.Library | None = None


def modules() -> list:
    """The kernel wrapper modules, in :data:`KERNELS` order."""
    return [importlib.import_module(f"{__package__}.{name}")
            for name in KERNELS]


def defines() -> dict:
    """Every kernel's nvcc defines."""
    return {k: v for m in modules() for k, v in m.CUDA_DEFINES.items()}


def declare(lib) -> None:
    """Declare on ``lib`` the ctypes signature of every ``sbt_*``
    function called: the launch check's own (csrc/scaled_gram.cu) and
    each kernel's."""
    lib.sbt_cuda_error_string.restype = ctypes.c_char_p
    lib.sbt_cuda_error_string.argtypes = [I32]
    for m in modules():
        m.declare(lib)


def counters() -> dict[str, tuple[Callable, str]]:
    """Every kernel's launch counters: ``key: (wrapper, attribute)``."""
    return {k: v for m in modules() for k, v in m.LAUNCH_COUNTERS.items()}


def library() -> ctypes.CDLL:
    """The kernel library, built on first use with every kernel's
    defines and its functions declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(native.build(defines()))
            declare(lib)
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.sbt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def ready(dev: torch.device, kernel: str) -> ctypes.CDLL:
    """The kernel library, with ``sbt_<kernel>_init`` (its functions'
    shared-memory size) run on ``dev`` once a device, never inside a
    CUDA-graph capture."""
    lib = library()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    with _lock:
        if (kernel, idx) not in _ready_devices:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"{kernel}: the first launch on a device must run "
                    "outside a CUDA-graph capture (warm it up eagerly)")
            with torch.cuda.device(idx):
                init = getattr(lib, f"sbt_{kernel}_init")
                check(lib, init(), f"{kernel} init")
            _ready_devices.add((kernel, idx))
    return lib


def operator(name: str, schema: str, cuda: Callable, meta: Callable,
             flops: Callable | None = None):
    """The torch operator ``sbt::<name>(<schema>)``, defined at its first
    use: ``cuda`` launches it, ``meta`` gives its output's shape, and
    ``flops`` (where given) is the formula ``FlopCounterMode`` counts.
    A ``make_fx`` trace records it as one node. (Defined through
    ``torch.library.Library``: a first call costs ~1 ms, where a
    ``torch.library.custom_op`` imports torch._dynamo, seconds.)"""
    global _library
    with _lock:
        try:
            return getattr(torch.ops.sbt, name)
        except (AttributeError, RuntimeError):
            pass
        if _library is None:  # its registrations live as long as it does
            _library = torch.library.Library("sbt", "DEF")
        _library.define(f"{name}{schema}")
        _library.impl(name, cuda, "CUDA")
        _library.impl(name, meta, "Meta")
        op = getattr(torch.ops.sbt, name)
        if flops is not None:
            from torch.utils.flop_counter import register_flop_formula

            register_flop_formula(op)(flops)
        return op


def stream(dev: torch.device) -> int:
    """The handle of ``dev``'s current CUDA stream."""
    return torch.cuda.current_stream(dev).cuda_stream
