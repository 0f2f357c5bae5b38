"""The port's CUDA kernels and estimator on the card.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips elsewhere with the reason "no CUDA device". The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX.)
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("shared_x", [True, False])
@pytest.mark.parametrize("op_dtype", ["float32", "bfloat16"])
def test_scaled_gram_kernel_matches_plain(cuda, op_dtype, shared_x):
    from spark_bagging_tpu_torch.ops.gram import (
        scaled_grams,
        scaled_grams_plain,
    )

    rng = np.random.default_rng(0)
    R, n, d, P = 3, 5000, 55, 28
    X = torch.from_numpy(rng.standard_normal(
        (n, d) if shared_x else (R, n, d)).astype(np.float32)).to(cuda)
    S = torch.from_numpy(
        rng.uniform(-0.3, 1.0, (R, n, P)).astype(np.float32)).to(cuda)
    before = scaled_grams.launches
    out = scaled_grams(X, S, op_dtype=op_dtype)
    again = scaled_grams(X, S, op_dtype=op_dtype)
    torch.cuda.synchronize()
    assert scaled_grams.launches == before + 2
    assert torch.equal(out, again)  # no atomics: runs repeat bitwise
    # fp32 sums of identical operands in another order: ~1e-6 of the
    # largest entry at 5000 rows
    assert _rel_err(out, scaled_grams_plain(X, S, op_dtype=op_dtype)) <= 1e-4


def test_scaled_gram_kernel_single_replica_and_odd_shapes(cuda):
    from spark_bagging_tpu_torch.ops.gram import (
        scaled_grams,
        scaled_grams_plain,
    )

    rng = np.random.default_rng(1)
    for n, d, P in ((1, 1, 1), (33, 9, 6), (1000, 13, 3), (777, 100, 10)):
        X = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
        S = torch.from_numpy(rng.uniform(0, 1, (n, P)).astype(np.float32))
        out = scaled_grams(X.to(cuda), S.to(cuda))
        assert out.shape == (P, d, d)
        assert _rel_err(out.cpu(), scaled_grams_plain(X, S)) <= 1e-5


def test_estimator_on_card_matches_cpu(cuda):
    from spark_bagging_tpu_torch import BaggingClassifier, LogisticRegression
    from spark_bagging_tpu_torch.ops.gram import scaled_grams
    from spark_bagging_tpu_torch.utils.datasets import make_classification

    X, y = make_classification(2000, 10, 4, seed=0)
    fits = {}
    for dev in ("cpu", "cuda"):
        before = scaled_grams.launches
        fits[dev] = BaggingClassifier(
            LogisticRegression(max_iter=2, hessian_impl="pallas"),
            n_estimators=12, oob_score=True, seed=0, device=dev,
        ).fit(X, y)
        launched = scaled_grams.launches - before
        assert (launched > 0) == (dev == "cuda")
    W = {k: v.ensemble_["W"].cpu() for k, v in fits.items()}
    assert _rel_err(W["cuda"], W["cpu"]) <= 1e-4
    np.testing.assert_allclose(fits["cuda"].predict_proba(X),
                               fits["cpu"].predict_proba(X), atol=1e-5)
    assert fits["cuda"].fit_report_["backend"] == "cuda"


def test_scaled_gram_kernel_depth_capped_row_splits(cuda):
    # enough replicas that occupancy alone would give each block more
    # rows than MAX_SPLIT_ROWS: the cap sets the row split
    from spark_bagging_tpu_torch.ops.gram import (
        MAX_SPLIT_ROWS,
        kernel_geometry,
        scaled_grams,
        scaled_grams_plain,
    )

    rng = np.random.default_rng(2)
    R, n, d, P = 200, 3 * MAX_SPLIT_ROWS + 5, 23, 10
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = kernel_geometry(n, d, P, R, n_sm)
    assert g["rows_per_split"] <= MAX_SPLIT_ROWS and g["splits"] >= 4
    X = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda)
    S = torch.from_numpy(
        rng.uniform(-0.3, 1.0, (R, n, P)).astype(np.float32)).to(cuda)
    out = scaled_grams(X, S)
    assert torch.equal(out, scaled_grams(X, S))
    assert _rel_err(out, scaled_grams_plain(X, S)) <= 1e-5
