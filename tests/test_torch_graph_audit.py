"""The port's graph audit (``analysis/graph_audit.py``), the torch twin
of the JAX package's jaxpr audit:

- the port's learner zoo passes ``audit_estimator`` on the CPU (the JAX
  package's members; ``mlp``, ``glm`` and ``forest_cls`` are tier-1's
  representatives, the rest ride in ``slow`` as the JAX test's do: they
  share those three graph shapes and the audit's rules are structural).
  The MLP's CPU forward sums its first layer in float64 (each
  multiply-add rounded back to float32, XLA's order: models/mlp.py), so
  its CPU audit allows wide dtypes and asserts float64 is the only one;
  its forward on the card is audited without the allowance
  (tests/test_torch_cuda.py);
- ``audit_executor`` passes on a CPU executor at its smallest and
  largest bucket;
- planted faults get the same verdict as their JAX twins: an ``.item()``
  in a forward (JAX: a host callback), a 2 MiB closure constant, a
  float64 promotion (JAX under ``jax.enable_x64``); and the port's own:
  a ``.numpy()`` round trip, a boolean-mask index, a ``data_ptr()`` read
  no counted kernel accounts for, the kernels a trace launched;
- donation: torch has none, so it is never checked and always
  inapplicable.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spark_bagging_tpu_torch.analysis import (  # noqa: E402
    AuditError,
    audit_estimator,
    audit_executor,
    audit_fn,
)


@pytest.fixture(scope="module")
def cls_data():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(48, 6)).astype(np.float32)
    y = (X[:, 0] - 0.3 * X[:, 1] > 0).astype(np.int64)
    return X, y


@pytest.fixture(scope="module")
def reg_data():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(48, 6)).astype(np.float32)
    y = (X[:, 0] + 0.1 * rng.normal(size=48)).astype(np.float32)
    return X, y


def _zoo():
    """(name, kind, fit function, wide dtypes the CPU forward may
    carry)."""
    import spark_bagging_tpu_torch as sbt

    def bag_c(learner):
        return lambda X, y: sbt.BaggingClassifier(
            learner, n_estimators=2, seed=0, device="cpu").fit(X, y)

    def bag_r(learner):
        return lambda X, y: sbt.BaggingRegressor(
            learner, n_estimators=2, seed=0, device="cpu").fit(X, y)

    slow = pytest.mark.slow
    return [
        # slow: GLM-family iterative solve — glm is the tier-1 rep
        pytest.param("logistic", "cls",
                     bag_c(sbt.LogisticRegression(max_iter=3)), set(),
                     marks=slow),
        # slow: same linear-forward family as logistic/glm
        pytest.param("svc", "cls", bag_c(sbt.LinearSVC(max_iter=3)), set(),
                     marks=slow),
        # slow: closed-form stats forward, the simplest graph in the zoo
        pytest.param("gaussian_nb", "cls", bag_c(sbt.GaussianNB()), set(),
                     marks=slow),
        pytest.param("mlp", "cls",
                     bag_c(sbt.MLPClassifier(hidden=4, max_iter=3)),
                     {"float64"}),
        # slow: factorized linear forward, between linear and mlp
        pytest.param("fm", "cls",
                     bag_c(sbt.FMClassifier(factor_size=2, max_iter=3)),
                     set(), marks=slow),
        # slow: closed-form linear solve — glm is the tier-1 rep
        pytest.param("linear", "reg", bag_r(sbt.LinearRegression()), set(),
                     marks=slow),
        pytest.param("glm", "reg",
                     bag_r(sbt.GeneralizedLinearRegression(max_iter=3)),
                     set()),
        # slow: boosted trees share the tree-forward graph family with
        # forest_cls, the tier-1 rep
        pytest.param("gbt", "reg",
                     bag_r(sbt.GBTRegressor(n_rounds=2, max_depth=2)),
                     set(), marks=slow),
        pytest.param("forest_cls", "cls",
                     lambda X, y: sbt.RandomForestClassifier(
                         n_estimators=2, max_depth=2, n_bins=8, seed=0,
                         device="cpu").fit(X, y), set()),
        # slow: same tree-forward structure as forest_cls
        pytest.param("forest_reg", "reg",
                     lambda X, y: sbt.RandomForestRegressor(
                         n_estimators=2, max_depth=2, n_bins=8, seed=0,
                         device="cpu").fit(X, y), set(), marks=slow),
    ]


@pytest.mark.parametrize("name,kind,build,wide", _zoo(),
                         ids=[z.values[0] for z in _zoo()])
def test_graph_audit_model_zoo(name, kind, build, wide, cls_data,
                               reg_data):
    """Every zoo member's aggregated forward is capture-clean on the
    CPU: no host syncs, no wide-dtype promotion beyond the declared
    CPU-only float64, bounded consts, no kernel launched (a serving
    forward uses none); donation inapplicable."""
    X, y = cls_data if kind == "cls" else reg_data
    est = build(X, y)
    report = audit_estimator(est, allow_wide_dtypes=bool(wide))
    assert report.ok and report.n_eqns > 0
    assert report.wide_dtypes == wide
    assert not report.host_syncs and report.opaque_kernels == {}
    assert report.const_bytes <= 1 << 20
    assert not report.donation_checked and report.donation_inapplicable
    assert not report.sync_debug_checked  # a CPU forward


def test_graph_audit_serving_executor(cls_data):
    """The serving path itself — the executor's forward at its smallest
    and largest bucket — passes the same audit."""
    from spark_bagging_tpu_torch import BaggingClassifier, LogisticRegression
    from spark_bagging_tpu_torch.serving import EnsembleExecutor

    X, y = cls_data
    clf = BaggingClassifier(LogisticRegression(max_iter=3), n_estimators=2,
                            seed=0, device="cpu").fit(X, y)
    ex = EnsembleExecutor(clf, min_bucket_rows=8, max_batch_rows=32)
    for rows in (None, 32):
        report = audit_executor(ex, n_rows=rows)
        assert report.ok and report.n_eqns > 0
        assert report.name == (
            f"EnsembleExecutor[BaggingClassifier]@{rows or 8}")


# -- planted faults: the same verdicts as the JAX twins -------------------


def test_audit_flags_host_sync_as_jax_flags_a_callback():
    import jax
    import jax.numpy as jnp
    from spark_bagging_tpu.analysis import audit_fn as jax_audit

    def with_cb(x):
        return jax.pure_callback(
            lambda v: np.asarray(v) * 2,
            jax.ShapeDtypeStruct((4,), jnp.float32), x,
        )

    ref = jax_audit(with_cb, jnp.zeros((4,), jnp.float32),
                    name="cb-fixture")

    def with_item(x):
        return x * x.sum().item()

    report = audit_fn(with_item, torch.zeros(4), name="item-fixture")
    assert report.ok == ref.ok is False
    assert any("_local_scalar_dense" in p for p in report.problems)
    with pytest.raises(AuditError):
        report.raise_if_bad()
    allowed = audit_fn(with_item, torch.zeros(4),
                       allow_callbacks=True, name="item-ok")
    assert allowed.ok and allowed.host_syncs


def test_audit_flags_oversized_consts_as_jax():
    import jax.numpy as jnp
    from spark_bagging_tpu.analysis import audit_fn as jax_audit

    baked_j = jnp.ones((1024, 512), jnp.float32)   # 2 MiB closure capture
    ref = jax_audit(lambda x: x @ baked_j, jnp.zeros((2, 1024),
                                                     jnp.float32))
    baked_t = torch.ones(1024, 512)
    report = audit_fn(lambda x: x @ baked_t, torch.zeros(2, 1024))
    assert report.ok == ref.ok is False
    assert report.const_bytes == ref.const_bytes == 2 << 20
    assert any("constant" in p for p in report.problems)
    assert any("constant" in p for p in ref.problems)


def test_audit_flags_float64_promotion_as_jax():
    import jax
    import jax.numpy as jnp
    from spark_bagging_tpu.analysis import audit_fn as jax_audit

    with jax.enable_x64(True):
        ref = jax_audit(lambda x: (x.astype(jnp.float64) * 2).astype(
            jnp.float32), jnp.zeros((4,), jnp.float32))
    report = audit_fn(lambda x: (x.double() * 2).float(), torch.zeros(4))
    assert report.ok == ref.ok is False
    assert report.wide_dtypes == ref.wide_dtypes == {"float64"}
    # an f64 pipeline is the caller's explicit choice; int64 is torch's
    # index dtype and never flagged
    assert audit_fn(lambda x: x * 2, torch.zeros(4, dtype=torch.float64)).ok
    assert audit_fn(lambda x: x.argmax(dim=-1), torch.zeros(3, 4)).ok


# -- the port's own cases -------------------------------------------------


def test_audit_reports_a_forward_that_leaves_torch():
    report = audit_fn(lambda x: torch.from_numpy(x.numpy() * 2),
                      torch.zeros(4))
    assert not report.ok
    assert any(".numpy()" in p for p in report.problems)
    report = audit_fn(lambda x: torch.from_numpy(np.asarray(x) + 1),
                      torch.zeros(4))
    assert any("np.asarray()" in p for p in report.problems)


def test_audit_flags_data_dependent_shapes():
    report = audit_fn(lambda x: x[x > 0].sum(), torch.randn(8))
    assert any("boolean mask" in p for p in report.problems)
    report = audit_fn(lambda x: torch.nonzero(x), torch.randn(8))
    assert "aten.nonzero" in report.host_syncs


def test_audit_lists_the_counted_kernels_a_trace_launched():
    from spark_bagging_tpu_torch.ops.gram import scaled_grams

    def pointer_read(x):
        x.data_ptr()
        return x + 1

    report = audit_fn(pointer_read, torch.zeros(4))
    assert any(".data_ptr()" in p for p in report.problems)

    def counted(x):
        # what a kernel wrapper does: read the pointers, count a launch
        x.data_ptr()
        scaled_grams.launches += 1
        return x + 1

    before = scaled_grams.launches
    try:
        report = audit_fn(counted, torch.zeros(4))
    finally:
        scaled_grams.launches = before
    assert report.ok
    assert report.opaque_kernels == {"scaled_gram": 1}
