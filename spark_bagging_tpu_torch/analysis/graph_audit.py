"""Graph audit — machine-checkable invariants of the port's traced
forwards.

The AST lint sees source; this engine sees what torch actually runs.
For the paths that must run at hardware speed (every model's aggregated
forward, the serving executor's per-bucket programs, which the executor
captures as CUDA graphs) it traces the real closure with
``torch.fx.experimental.proxy_tensor.make_fx`` on the caller's device
and asserts the invariants that keep it capture-clean:

- **no host syncs**: ``aten._local_scalar_dense`` (``.item()``,
  ``float()`` of a tensor), ops whose output shape depends on the data
  (``nonzero``, ``masked_select``, ``unique``, boolean-mask indexing)
  and copies from the device to the CPU are one host round-trip per
  launch — and a capture refuses them. A forward that leaves torch
  inside the closure (``.numpy()``, ``np.asarray``, ``.tolist()``, a
  ``data_ptr()`` read no counted kernel accounts for) is reported as a
  problem, not a crash. On a CUDA device the audit also runs one real
  call under ``torch.cuda.set_sync_debug_mode("error")``;
- **no f64 promotion**: ``float64``/``complex128`` produced from
  narrower inputs runs at a fraction of the fp32 rate and doubles the
  buffers. ``int64`` is torch's index dtype (``gather``, ``argmax``)
  and is not flagged;
- **bounded baked constants**: a closure that captures big tensors
  (the graph's ``get_attr`` constants) bakes them into every bucket's
  program — params must flow in as arguments, not closure captures;
- **hand-written kernels stay visible**: a ``ctypes`` kernel launch is
  invisible to the dispatcher, so the report lists the launches the
  port's kernel wrappers counted during the trace (``opaque_kernels``)
  — an audited forward can never silently lose a kernel.

torch has no buffer donation (the port's ``donate_input`` is inert), so
``donation_checked`` is always False and ``donation_inapplicable``
always True.

``audit_estimator`` / ``audit_executor`` wrap these for the model zoo
and the serving subsystem, with the reference package's signatures.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

__all__ = [
    "AuditError",
    "AuditReport",
    "audit_fn",
    "audit_estimator",
    "audit_executor",
]

# ops that pull a value to the host, or whose output shape depends on
# the data (a hidden nonzero): each is a device->host wait per launch
_SYNC_OPS = {
    "aten._local_scalar_dense", "aten.item", "aten.nonzero",
    "aten.nonzero_numpy", "aten.argwhere", "aten.masked_select",
    "aten.unique", "aten._unique", "aten._unique2", "aten.unique_dim",
    "aten.unique_consecutive",
}
# Tensor methods that hand a traced value to the host outside torch
_ESCAPES = {"numpy": ".numpy()", "__array__": "np.asarray()",
            "tolist": ".tolist()", "data_ptr": ".data_ptr()"}

# generous by default: an aggregated forward's consts should be scalars
# and small index vectors, never the ensemble itself
DEFAULT_MAX_CONST_BYTES = 1 << 20  # 1 MiB
DEFAULT_MAX_CONSTS = 64

_WIDE = {"float64", "complex128"}


class AuditError(AssertionError):
    """An audited program violates a capture-cleanliness invariant."""


@dataclass
class AuditReport:
    """What the audit saw; ``ok`` iff ``problems`` is empty."""

    name: str
    n_eqns: int = 0
    primitives: set[str] = field(default_factory=set)
    const_count: int = 0
    const_bytes: int = 0
    wide_dtypes: set[str] = field(default_factory=set)
    donation_checked: bool = False
    donation_applied: bool = False
    donation_inapplicable: bool = False
    # host syncs seen in the graph (or in the trace that stopped at one)
    host_syncs: list[str] = field(default_factory=list)
    # counted hand-written kernel launches during the trace, by kernel
    opaque_kernels: dict[str, int] = field(default_factory=dict)
    # a real call ran under torch.cuda.set_sync_debug_mode("error")
    sync_debug_checked: bool = False
    problems: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.problems

    def raise_if_bad(self) -> "AuditReport":
        if self.problems:
            raise AuditError(
                f"audit of {self.name} failed:\n  - "
                + "\n  - ".join(self.problems)
            )
        return self


def _kernel_counts() -> dict[str, int]:
    """The port's kernel wrappers' launch counters (their launches, not
    the sub-counts of a kind of launch)."""
    from spark_bagging_tpu_torch.ops import kernels

    return {k: getattr(fn, attr)
            for k, (fn, attr) in kernels.counters().items()
            if attr == "launches"}


def _op_name(target: Any) -> str:
    packet = getattr(target, "overloadpacket", None)
    return str(packet if packet is not None else target)


def _vals(value: Any) -> list:
    import torch

    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [v for x in value for v in _vals(x)]
    return []


def _node_vals(arg: Any) -> list:
    """The example tensors behind a node argument (nodes carry theirs
    in ``meta["val"]``)."""
    import torch.fx

    if isinstance(arg, torch.fx.Node):
        return _vals(arg.meta.get("val"))
    if isinstance(arg, (list, tuple)):
        return [v for a in arg for v in _node_vals(a)]
    return []


def _dtype(t: Any) -> str:
    return str(t.dtype).replace("torch.", "")


def _host_sync(node: Any, prim: str) -> str | None:
    """Why this graph node waits for the device, or None."""
    if prim in _SYNC_OPS:
        return prim
    if prim == "aten.index" and len(node.args) > 1 and any(
            _dtype(v) == "bool" for v in _node_vals(node.args[1])):
        return "aten.index (boolean mask)"
    outs = _vals(node.meta.get("val"))
    ins = _node_vals(list(node.args)) + _node_vals(
        list(node.kwargs.values()))
    if (outs and all(o.device.type == "cpu" for o in outs)
            and any(i.device.type == "cuda" for i in ins)):
        return f"{prim} (device -> cpu copy)"
    return None


def audit_fn(
    fn: Callable,
    *example_args: Any,
    name: str = "<fn>",
    allow_callbacks: bool = False,
    allow_wide_dtypes: bool = False,
    max_const_bytes: int = DEFAULT_MAX_CONST_BYTES,
    max_consts: int = DEFAULT_MAX_CONSTS,
    donate_argnums: tuple[int, ...] | None = None,
) -> AuditReport:
    """Trace ``fn(*example_args)`` with ``make_fx`` on the arguments'
    device and audit the graph.

    ``allow_callbacks`` lets host syncs pass (the reference's name for
    them is host callbacks). Wide-dtype findings are suppressed for
    dtypes some input ALREADY has (auditing an f64 pipeline is the
    caller's explicit choice). When an input lies on a CUDA device, one
    real call also runs under ``torch.cuda.set_sync_debug_mode("error")``.
    ``donate_argnums`` is accepted for the reference's signature; torch
    has no donation to verify.
    """
    import torch
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.overrides import TorchFunctionMode
    from torch.utils._pytree import tree_leaves

    report = AuditReport(name=name, donation_inapplicable=True)
    del donate_argnums  # no donation in torch: nothing to lower or check
    inputs = [x for x in tree_leaves(example_args)
              if isinstance(x, torch.Tensor)]
    input_wide = {_dtype(x) for x in inputs} & _WIDE

    escapes: list[str] = []

    class _Escapes(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            what = _ESCAPES.get(getattr(func, "__name__", ""))
            if what is not None:
                escapes.append(what)
            return func(*args, **(kwargs or {}))

    def sync(what: str) -> None:
        report.host_syncs.append(what)
        if not allow_callbacks:
            report.problems.append(
                f"host sync `{what}` in the traced program: one host "
                "round-trip per launch, and a CUDA-graph capture "
                "refuses it"
            )

    before = _kernel_counts()
    gm = None
    try:
        with _Escapes():
            gm = make_fx(fn, tracing_mode="real")(*example_args)
    except RuntimeError as e:
        if "_local_scalar_dense" in str(e):
            report.primitives.add("aten._local_scalar_dense")
            sync("aten._local_scalar_dense (.item()/.tolist()/float() "
                 "of a tensor)")
        else:
            report.problems.append(
                f"the forward could not be traced: {type(e).__name__}: "
                + str(e).strip().splitlines()[0])
    after = _kernel_counts()
    report.opaque_kernels = {k: after[k] - before[k] for k in after
                             if after[k] > before[k]}
    for what in dict.fromkeys(escapes):
        if what == ".data_ptr()" and report.opaque_kernels:
            continue  # the counted kernels' own launch arguments
        report.problems.append(
            f"the forward leaves torch: {what} on a traced tensor — its "
            "value enters the program as a host constant (or a raw "
            "pointer no counted kernel accounts for)"
        )

    if gm is not None:
        for node in gm.graph.nodes:
            if node.op == "get_attr":
                const = getattr(gm, node.target)
                if isinstance(const, torch.Tensor):
                    report.const_count += 1
                    report.const_bytes += const.numel() * const.element_size()
                continue
            if node.op != "call_function":
                continue
            report.n_eqns += 1
            prim = _op_name(node.target)
            report.primitives.add(prim)
            what = _host_sync(node, prim)
            if what is not None:
                sync(what)
            for t in _vals(node.meta.get("val")):
                dt = _dtype(t)
                if dt in _WIDE and dt not in input_wide:
                    report.wide_dtypes.add(dt)

    # -- constants baked into the closure ------------------------------
    if report.const_count > max_consts:
        report.problems.append(
            f"{report.const_count} baked-in constants (max {max_consts});"
            " pass big tensors as arguments, not closure captures"
        )
    if report.const_bytes > max_const_bytes:
        report.problems.append(
            f"{report.const_bytes} bytes of baked-in constants (max "
            f"{max_const_bytes}); each captured bucket would carry its "
            "own copy"
        )
    if report.wide_dtypes and not allow_wide_dtypes:
        report.problems.append(
            f"wide dtypes promoted inside the program: "
            f"{sorted(report.wide_dtypes)} (inputs were not wide); "
            "float64 runs at a fraction of the fp32 rate"
        )

    # -- one real call with synchronizing operations refused -----------
    devices = {x.device for x in inputs if x.device.type == "cuda"}
    if devices:
        dev = next(iter(devices))
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn(*example_args)
        except RuntimeError as e:
            what = str(e).strip().splitlines()[0]
            if not allow_callbacks:
                report.problems.append(
                    "a real call under torch.cuda.set_sync_debug_mode"
                    f"('error') synchronized: {what}")
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        torch.cuda.synchronize(dev)
        report.sync_debug_checked = True
    return report


def audit_estimator(
    est: Any,
    *,
    n_rows: int = 8,
    check_donation: bool = True,
    **kw: Any,
) -> AuditReport:
    """Audit a fitted estimator's serving seam — the exact
    ``aggregated_forward`` closure the executor captures per bucket.
    Raises :class:`AuditError` on violation; returns the report."""
    import torch

    fn, params, subspaces = est.aggregated_forward()
    X = torch.zeros((n_rows, int(est.n_features_in_)), dtype=torch.float32,
                    device=subspaces.device)
    report = audit_fn(
        fn, params, subspaces, X,
        name=f"{type(est).__name__}.aggregated_forward",
        donate_argnums=(2,) if check_donation else None,
        **kw,
    )
    return report.raise_if_bad()


def audit_executor(ex: Any, *, n_rows: int | None = None,
                   **kw: Any) -> AuditReport:
    """Audit a serving :class:`EnsembleExecutor`'s forward at one
    bucket shape (default: its smallest bucket) — the program online
    traffic actually runs."""
    import torch

    rows = int(n_rows if n_rows is not None else ex.min_bucket_rows)
    X = torch.zeros((rows, ex.n_features), dtype=torch.float32,
                    device=ex._subspaces.device)
    report = audit_fn(
        ex._fn, ex._params, ex._subspaces, X,
        name=f"EnsembleExecutor[{type(ex.model).__name__}]@{rows}",
        **kw,
    )
    return report.raise_if_bad()
