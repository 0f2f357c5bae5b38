"""The seam of the port's hand-written kernels (ops/kernels.py) and the
one dispatch rule of the vote forwards (``ensemble.kernel_vote``).

CPU (tier-1), no card and no compiler: the dispatch rule holds in
exactly its cases, for the soft-vote and the tree-vote kernel; every
kernel of the list is built with its tiling; every ``sbt_*`` function a
wrapper calls is declared, on a stub library, with as many arguments as
the call passes, and every declaration is its C definition's types; the
launch counters keep the keys the reports read.
"""

import ast
import ctypes
import inspect
import re
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from spark_bagging_tpu_torch import (  # noqa: E402
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    GaussianNB,
    GBTClassifier,
    LinearSVC,
    LogisticRegression,
    MLPClassifier,
)
from spark_bagging_tpu_torch.ensemble import kernel_vote  # noqa: E402
from spark_bagging_tpu_torch.ops import kernels  # noqa: E402
from spark_bagging_tpu_torch.ops import soft_vote as sv  # noqa: E402
from spark_bagging_tpu_torch.ops import tree_vote as tv  # noqa: E402
from spark_bagging_tpu_torch.ops.aggregate import mean_aggregate  # noqa: E402
from spark_bagging_tpu_torch.utils import native  # noqa: E402


def _fake(device, dtype=torch.float32):
    # the rule reads a tensor's device and dtype only, so a CUDA tensor
    # is stood in for where there is no card
    return SimpleNamespace(device=torch.device(device), dtype=dtype)


def _soft_vote_case(case):
    learner = {"logistic_adam": LogisticRegression(solver="adam"),
               "trees": DecisionTreeClassifier(), "svc": LinearSVC(),
               "gaussian_nb": GaussianNB(), "mlp": MLPClassifier()}.get(
                   case, LogisticRegression())
    params = {"W": _fake("cuda", torch.float64 if case == "float64_W"
                         else torch.float32)}
    X = _fake("cpu" if case == "cpu" else "cuda",
              torch.float64 if case == "float64_X" else torch.float32)
    C = {"classes_at_limit": sv.MAX_CLASSES,
         "classes_above_limit": sv.MAX_CLASSES + 1}.get(case, 7)
    R = {"replicas_at_limit": sv.MAX_REPLICAS,
         "replicas_above_limit": sv.MAX_REPLICAS + 1}.get(case, 1000)
    return (learner, params, X, C, R,
            "hard" if case == "hard_vote" else "soft", case != "subspaced")


def _tree_vote_case(case):
    depth = {"depth_at_limit": tv.MAX_DEPTH,
             "depth_above_limit": tv.MAX_DEPTH + 1}.get(case, 5)
    learner = {"gbt": GBTClassifier(), "tree_regressor": DecisionTreeRegressor(),
               "logistic": LogisticRegression()}.get(
                   case, DecisionTreeClassifier(max_depth=depth))
    params = {"threshold": _fake("cuda", torch.float64
                                 if case == "float64_threshold"
                                 else torch.float32),
              "feature": None, "leaf_logp": None}
    X = _fake("cpu" if case == "cpu" else "cuda",
              torch.float64 if case == "float64_X" else torch.float32)
    C = {"classes_at_limit": tv.MAX_CLASSES,
         "classes_above_limit": tv.MAX_CLASSES + 1}.get(case, 7)
    R = {"replicas_at_limit": tv.MAX_REPLICAS,
         "replicas_above_limit": tv.MAX_REPLICAS + 1}.get(case, 256)
    return (learner, params, X, C, R,
            "soft" if case == "tree_soft" else "hard", False)


_SOFT_VOTE_CASES = [
    ("logistic", True),
    ("logistic_adam", True),
    ("hard_vote", False),
    ("subspaced", False),
    ("cpu", False),
    ("float64_X", False),
    ("float64_W", False),
    ("classes_at_limit", True),
    ("classes_above_limit", False),
    ("replicas_at_limit", True),
    ("replicas_above_limit", False),
    ("trees", False),
    ("svc", False),
    ("gaussian_nb", False),
    ("mlp", False),
]
_TREE_VOTE_CASES = [
    ("tree_hard", True),
    ("tree_soft", False),
    ("gbt", False),
    ("tree_regressor", False),
    ("logistic", False),
    ("cpu", False),
    ("float64_X", False),
    ("float64_threshold", False),
    ("depth_at_limit", True),
    ("depth_above_limit", False),
    ("classes_at_limit", True),
    ("classes_above_limit", False),
    ("replicas_at_limit", True),
    ("replicas_above_limit", False),
]


@pytest.mark.parametrize("kernel, case, want", [
    *(("soft_vote", c, w) for c, w in _SOFT_VOTE_CASES),
    *(("tree_vote", c, w) for c, w in _TREE_VOTE_CASES),
])
def test_dispatch_rule(monkeypatch, kernel, case, want):
    # the launches are stood in for: where the rule takes a kernel, the
    # vote is that kernel's sums with its finish, else None
    launched = object()
    monkeypatch.setattr(sv, "soft_vote_quanta", lambda *a, **k: launched)
    monkeypatch.setattr(tv, "tree_vote_counts", lambda *a, **k: launched)
    make = _soft_vote_case if kernel == "soft_vote" else _tree_vote_case
    learner, params, X, C, R, voting, identity = make(case)
    got = kernel_vote(learner, params, None, X, C, R, voting=voting,
                      identity_subspace=identity)
    finish = sv.soft_vote_mean if kernel == "soft_vote" else mean_aggregate
    assert got == ((launched, finish) if want else None)


class _StubLibrary:
    """A loaded library's stand-in: every function looked up is a plain
    object that keeps what is declared on it."""

    def __getattr__(self, name):
        fn = SimpleNamespace()
        setattr(self, name, fn)
        return fn


def _declared(declare) -> dict:
    """``name: (restype, argtypes)`` of what ``declare`` declares."""
    stub = _StubLibrary()
    declare(stub)
    return {k: (v.restype, v.argtypes) for k, v in vars(stub).items()}


def _module(name):
    return dict(zip(kernels.KERNELS, kernels.modules()))[name]


@pytest.mark.parametrize("name", kernels.KERNELS)
def test_the_kernel_is_built_with_its_tiling(name):
    # the library's flags carry every kernel's defines, whichever
    # wrapper launches first: they come from the one list; the functions
    # the wrapper declares are defined in one source
    mod = _module(name)
    flags = native._flags(kernels.defines())
    assert mod.CUDA_DEFINES
    for k, v in mod.CUDA_DEFINES.items():
        assert f"-D{k}={v}" in flags
    sources = [open(s).read() for s in native._sources()]
    for fn in _declared(mod.declare):
        assert sum(f" {fn}(" in src for src in sources) == 1, fn


def _calls(module):
    """``(function, arguments)`` of every ``sbt_*`` call in ``module``'s
    source: ``lib.sbt_x(...)``, and ``kernels.ready(dev, "x")``'s
    ``sbt_x_init()``."""
    for node in ast.walk(ast.parse(inspect.getsource(module))):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        if node.func.attr.startswith("sbt_"):
            yield node.func.attr, len(node.args)
        elif node.func.attr == "ready":
            yield f"sbt_{node.args[1].value}_init", 0


@pytest.mark.parametrize("name", ["kernels", *kernels.KERNELS])
def test_every_called_function_is_declared_as_called(name):
    # the library's declarations made on a stub, no card and no
    # compiler: a call whose argument count drifted from its signature
    # would pass ctypes a wrong frame
    declared = _declared(kernels.declare)
    calls = list(_calls(kernels if name == "kernels" else _module(name)))
    assert calls
    for fn, n_args in calls:
        assert fn in declared, f"{fn} is called but not declared"
        restype, argtypes = declared[fn]
        assert restype is not None and len(argtypes) == n_args, fn


_C_TYPES = {"int": kernels.I32, "long long": kernels.I64,
            "const char*": ctypes.c_char_p}


def _c_definitions() -> dict:
    """``name: (restype, argtypes)`` of every ``sbt_*`` function defined
    in csrc/, in ctypes terms (any pointer a ``void*``)."""
    out = {}
    for path in native._sources():
        src = open(path).read()
        for ret, name, params in re.findall(
                r"^(int|const char\*) (sbt_\w+)\(([^)]*)\)\s*\{", src,
                re.M):
            args = [p.strip() for p in params.split(",") if p.strip()]
            out[name] = (_C_TYPES[ret], [
                kernels.VP if "*" in a
                else _C_TYPES[a.rsplit(" ", 1)[0].strip()] for a in args])
    return out


def test_every_declaration_is_its_c_definition():
    declared = _declared(kernels.declare)
    defined = _c_definitions()
    assert len(declared) == 11
    for fn, signature in declared.items():
        assert signature == defined.get(fn), fn


def test_the_launch_counters_keep_their_keys():
    # the keys graph_audit and chip_smoke.py report
    counters = kernels.counters()
    assert list(counters) == ["scaled_gram", "scaled_gram_wgmma",
                              "binned_left_stats",
                              "binned_left_stats_float", "bin_codes",
                              "soft_vote", "tree_vote"]
    for fn, attr in counters.values():
        assert isinstance(getattr(fn, attr), int)
