"""Joining more than one process: the port of the JAX package's
``parallel/distributed.py``.

The JAX package joins a multi-host run with ``jax.distributed``; the
port joins it with ``torch.distributed`` over the gloo backend: every
collective of a process-spanning mesh (``parallel/compat.py``) stages
its values through host memory and exchanges them over gloo, so a
CUDA build and a CPU build join the same way. One entry point that is
safe to call in a single-process run.

After the join, ``make_mesh`` is called by every process with that
process's own devices, and lays out the devices of all of them in
process order (``parallel/mesh.py``).
"""

from __future__ import annotations

import datetime
import logging
import os

import torch

log = logging.getLogger(__name__)

#: the launcher environment whose presence means "join" (torchrun's)
LAUNCHER_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")

# the timeout the process group was created with (the subgroups of a
# process-spanning mesh take the same one)
_timeout_s: float | None = None


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    """Has this process joined a process group?"""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 outside a joined run), as
    ``jax.process_index()``."""
    return _dist().get_rank() if is_initialized() else 0


def process_count() -> int:
    """The number of joined processes (1 outside a joined run)."""
    return _dist().get_world_size() if is_initialized() else 1


def group_timeout_s() -> float:
    """Seconds a cross-process collective waits before it fails: the
    process group's, else ``compat.COLLECTIVE_TIMEOUT_S``."""
    if _timeout_s is not None:
        return _timeout_s
    from spark_bagging_tpu_torch.parallel.compat import COLLECTIVE_TIMEOUT_S

    return COLLECTIVE_TIMEOUT_S


def local_device_count() -> int:
    """This process's devices: its CUDA devices, else the one CPU."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def global_device_count() -> int:
    """The sum of every joined process's local devices."""
    n = local_device_count()
    if process_count() == 1:
        return n
    counts: list = [None] * process_count()
    _dist().all_gather_object(counts, n)
    return int(sum(counts))


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    timeout_s: float | None = None,
) -> int:
    """Join a multi-process run if configured; return the global device
    count.

    ``coordinator_address`` (``host:port``, process 0's) with
    ``num_processes`` and ``process_id`` joins explicitly over gloo.
    With no arguments the standard launcher environment (``MASTER_ADDR``,
    ``WORLD_SIZE``, ``RANK``; ``MASTER_PORT`` too) joins the same way;
    without it this is a no-op (one process). ``timeout_s`` bounds every
    cross-process collective (default ``compat.COLLECTIVE_TIMEOUT_S``).
    """
    global _timeout_s
    if coordinator_address is None and (
        num_processes is not None or process_id is not None
    ):
        raise ValueError(
            "num_processes/process_id require coordinator_address — "
            "without it they would be silently ignored"
        )
    dist = _dist()
    explicit = coordinator_address is not None
    from_env = not explicit and all(k in os.environ for k in LAUNCHER_ENV)
    if explicit or from_env:
        if is_initialized():
            # only an already-initialized group is tolerated
            log.debug("torch.distributed already initialized")
        else:
            if timeout_s is None:
                from spark_bagging_tpu_torch.parallel.compat import (
                    COLLECTIVE_TIMEOUT_S,
                )

                timeout_s = COLLECTIVE_TIMEOUT_S
            kwargs = dict(
                backend="gloo",
                timeout=datetime.timedelta(seconds=float(timeout_s)),
            )
            if explicit:
                kwargs.update(init_method=f"tcp://{coordinator_address}",
                              world_size=num_processes, rank=process_id)
            else:
                kwargs.update(init_method="env://")
            try:
                dist.init_process_group(**kwargs)
            except (RuntimeError, ValueError) as e:
                # an EXPLICIT (or launcher-configured) join that fails
                # must raise, not degrade to a single-process run where
                # every process believes it is process 0 — concurrent
                # "single writers" would then tear shared checkpoints
                raise RuntimeError(
                    "explicit multi-host join failed (is the "
                    "coordinator reachable, and are num_processes and "
                    f"process_id consistent?): {e}"
                ) from e
            _timeout_s = float(timeout_s)
    n_devices = global_device_count()
    log.info("distributed: %d process(es), %d global device(s)",
             process_count(), n_devices)
    return n_devices
