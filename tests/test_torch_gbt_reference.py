"""The port's bagged binary GBTs against the benchmark's plain Newton
boosting reference (``perfbench/reference/gbt_newton.py``), on the CPU.

``BaggingClassifier(GBTClassifier(n_rounds=5, max_depth=4))`` of 4
replicas on 3,000 x 28 rows of the ``higgs_gbt`` configuration's mixture
holds the reference's ``split_gap``, ``leaf_gap`` and ``margin_gap``
within the limits of the ``fit.higgs_gbt`` cell; a round's leaf altered,
a round skipped and the learning rate doubled each read over a limit.
The configuration's mixture is the port's ``synthetic_higgs``: the same
centres and priors, so the same rows from the same generator.

The CPU runs the configuration with ``hist_dtype="float32"``: the port's
CPU path sums the moments unrounded whatever ``hist_dtype`` says
(models/tree.py ``_hdt``), and the reference rounds them only where the
configuration says bfloat16.
"""

import copy
import importlib.util
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu_torch.utils.datasets import synthetic_higgs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERFBENCH = os.path.join(ROOT, "perfbench")
# at the end of the path: the repository's own bench.py keeps its name
if PERFBENCH not in sys.path:
    sys.path.append(PERFBENCH)

from reference import gbt_newton  # noqa: E402


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(PERFBENCH, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


data = _load("bench/data.py", "perfbench_bench_data_for_gbt_tests")

N_ROWS, R, ROUNDS = 3000, 4, 5
SEED = 2**31 + 24


def _json(*parts):
    with open(os.path.join(PERFBENCH, *parts)) as f:
        return json.load(f)


CONFIG = _json("configs", "higgs_gbt.json")
LIMITS = _json("limits", "fit.higgs_gbt.json")


def _config(**learner):
    cfg = copy.deepcopy(CONFIG)
    cfg["data"].update(n_rows=N_ROWS, n_predict_rows=500)
    cfg["estimator"]["params"]["n_estimators"] = R
    cfg["estimator"]["learner"]["params"].update(
        {"n_rounds": ROUNDS, "hist_dtype": "float32", **learner})
    return cfg


@pytest.fixture(scope="module")
def tables():
    return data.make(_config()["data"], SEED, torch.device("cpu"))


def _fit(cfg, tables, fit_seed=7):
    est = cfg["estimator"]
    learner = T.GBTClassifier(**est["learner"]["params"])
    bag = T.BaggingClassifier(learner, seed=fit_seed, device="cpu",
                              **est["params"])
    bag.fit(tables.X_fit, tables.y_fit)
    return {"seed": fit_seed, "params": dict(bag.ensemble_),
            "subspaces": bag.subspaces_}


def _numbers(rec, tables):
    ref = gbt_newton.Reference(_config(), tables, torch.device("cpu"))
    return ref.fit_numbers([rec], [(0, r) for r in range(R)])


def _within(nums):
    return all(nums[k] <= LIMITS[k] for k in LIMITS)


@pytest.fixture(scope="module")
def sound(tables):
    return _fit(_config(), tables)


def test_port_holds_the_cell_limits(sound, tables):
    nums = _numbers(sound, tables)
    assert set(nums) == set(LIMITS)
    assert _within(nums), nums
    # and by a wide margin: the reference follows the port's own trees
    assert nums["split_gap"] <= 1e-3 * LIMITS["split_gap"] + 1e-12
    for k in ("leaf_gap", "margin_gap"):
        assert nums[k] <= LIMITS[k] / 10, nums


def test_a_round_leaf_altered_reads_over_a_limit(sound, tables):
    rec = copy.deepcopy(sound)
    leaf = rec["params"]["leaf"].clone()
    leaf[:, 2, 0] += 1e-2 * leaf[:, 2].abs().amax(dim=1)
    rec["params"]["leaf"] = leaf
    nums = _numbers(rec, tables)
    assert nums["leaf_gap"] > LIMITS["leaf_gap"], nums
    assert not _within(nums)


def test_a_round_skipped_reads_over_a_limit(tables):
    """A fit of one round more with its round 2 cut out: the trees after
    it were grown on a margin the cut round had moved."""
    rec = _fit(_config(n_rounds=ROUNDS + 1), tables)
    M = 2 ** CONFIG["estimator"]["learner"]["params"]["max_depth"] - 1
    p = rec["params"]
    keep = [m for m in range(ROUNDS + 1) if m != 2]
    for k in ("feature", "threshold", "gain"):
        p[k] = torch.cat([p[k][:, m * M:(m + 1) * M] for m in keep], dim=1)
    p["leaf"] = p["leaf"][:, keep]
    nums = _numbers(rec, tables)
    assert nums["leaf_gap"] > LIMITS["leaf_gap"], nums
    assert nums["margin_gap"] > LIMITS["margin_gap"], nums


def test_lr_doubled_reads_over_a_limit(tables):
    rec = _fit(_config(lr=0.2), tables)
    nums = _numbers(rec, tables)
    assert nums["leaf_gap"] > LIMITS["leaf_gap"], nums
    assert nums["margin_gap"] > LIMITS["margin_gap"], nums


def test_mixture_is_synthetic_higgs():
    spec = CONFIG["data"]
    centers, priors = data.structure(spec)
    assert centers.shape == (2, 28) and centers.dtype == np.float32
    np.testing.assert_array_equal(priors, [0.5, 0.5])
    # synthetic_higgs draws its centres first from default_rng(11), then
    # the labels and the unit clouds from the same generator
    n = 500
    X, y = synthetic_higgs(n)
    rng = np.random.default_rng(spec["structure_seed"])
    rng.normal(0.0, spec["class_sep"], (2, spec["n_features"]))
    y_again = rng.choice(2, size=n, p=priors).astype(np.int32)
    noise = rng.standard_normal((n, spec["n_features"]), np.float32)
    np.testing.assert_array_equal(y, y_again)
    np.testing.assert_array_equal(X, noise + centers[y])


# -- the leaf sums ----------------------------------------------------------

def _leaf_case(R, n, L, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    node = torch.randint(0, L, (R, n), generator=g, dtype=torch.int32)
    h = 0.25 * torch.randint(0, 4, (R, n), generator=g).float()
    z = 2.0 * torch.rand((R, n), generator=g) - 0.9
    S = torch.stack([h, h * z, h * z * z], dim=-1)
    want = torch.zeros((R, L, 3), dtype=torch.float64)
    for r in range(R):
        want[r].index_add_(0, node[r].long(), S[r].double())
    scale = torch.zeros((R, L, 3), dtype=torch.float64)
    for r in range(R):
        scale[r].index_add_(0, node[r].long(), S[r].double().abs())
    return node.to(device), S.to(device), want, scale


def test_leaf_sums_by_blocks_equal_the_float64_sums():
    """Rows in uneven blocks: each block's float32 product, the blocks
    added in float64, within a float32 rounding of the exact sums;
    integer statistics exactly the one product's, and one block the one
    product's bits."""
    from spark_bagging_tpu_torch.models.tree import _leaf_sums

    node, S, want, scale = _leaf_case(3, 10_001, 16)
    got = _leaf_sums(node, S, 16, block_rows=512).double()
    assert float(((got - want).abs() / scale.clamp_min(1e-30)).max()) < 1e-6
    counts = torch.randint(0, 5, (3, 10_001, 7)).float()
    onehot = torch.nn.functional.one_hot(node.long(), 16).float()
    assert torch.equal(_leaf_sums(node, counts, 16, block_rows=512),
                       onehot.transpose(1, 2) @ counts)
    assert torch.equal(_leaf_sums(node, S, 16, block_rows=20_000),
                       onehot.transpose(1, 2) @ S)


@pytest.mark.cuda
def test_card_leaf_sums_at_config_7_shapes():
    """The card's leaf sums of 32 replicas over 800,000 rows (config 7's
    round) within 1e-6 of each leaf's absolute sum of the float64 sums:
    one float32 product over every row is ~1e-5 off there."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    node, S, want, scale = _leaf_case(32, 800_000, 16, device="cuda")
    learner = T.GBTClassifier(max_depth=4)
    got = learner._leaf_stats(node, S).double().cpu()
    assert float(((got - want).abs() / scale.clamp_min(1e-30)).max()) < 1e-6
