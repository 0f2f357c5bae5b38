"""The soft-vote kernel (ops/soft_vote.py, csrc/soft_vote.cu) and the
batch forward's dispatch to it.

CPU (tier-1): the plain version is the torch chain it replaces, bit for
bit; a CPU ``predict_proba`` of a logistic bag is that chain's, bit for
bit, and launches nothing; the launch geometry. (The dispatch rule and
the kernel's build and C interface: tests/test_torch_kernels.py.)

Card (``cuda`` marker, skipped here with "no CUDA device"; the file
imports no JAX, so on the card run
``python -m pytest --noconftest -m cuda tests/test_torch_soft_vote.py``):
the kernel against a float64 reference at the benchmark cell's shapes
and at edge shapes, within 2e-6 an entry of the mean probabilities
(3xTF32 products, probabilities summed exactly in fixed point; the TF32
forward misses by ~6e-4); a class of probability 1e-9 and 1e-12 in
every replica within 2e-4 of its size, and ``predict_log_proba`` there
against the torch chain; scores of +-1e4; sums independent of how the
replicas are split; bitwise repeats, eager and through a CUDA-graph
capture; launches per forward.
"""

import itertools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spark_bagging_tpu_torch import (  # noqa: E402
    BaggingClassifier,
    DecisionTreeClassifier,
    GaussianNB,
    LinearSVC,
    LogisticRegression,
    MLPClassifier,
)
from spark_bagging_tpu_torch.ensemble import kernel_vote  # noqa: E402
from spark_bagging_tpu_torch.ops import kernels  # noqa: E402
from spark_bagging_tpu_torch.ops import soft_vote as sv  # noqa: E402
from spark_bagging_tpu_torch.ops.soft_vote import (  # noqa: E402
    HI_QUANTUM,
    LO_QUANTUM,
    MAX_CLASSES,
    kernel_geometry,
    soft_vote_mean,
    soft_vote_quanta,
    soft_vote_sums_plain,
)
from spark_bagging_tpu_torch.utils.datasets import make_classification  # noqa: E402

# per entry of the mean probabilities (the sums over R), against float64
MEAN_TOL = 2e-6
# relative, on a class of tiny probability in every replica: the scores'
# 3xTF32 error, ~3e-5 of a probability at scores of ~-28
TINY_REL_TOL = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _inputs(n, d, C, R, seed=0, scale=0.3, device="cpu"):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    W = (scale * rng.standard_normal((R, d + 1, C))).astype(np.float32)
    W[:, -1, :] = rng.standard_normal((R, C))  # the bias row
    return (torch.from_numpy(X).to(device), torch.from_numpy(W).to(device))


# -- CPU -----------------------------------------------------------------

@pytest.mark.parametrize("n, d, C, R", [(50, 6, 3, 4), (33, 1, 2, 1),
                                        (20, 12, 9, 7)])
def test_plain_is_the_torch_chain_it_replaces(n, d, C, R):
    X, W = _inputs(n, d, C, R)
    chain = torch.softmax(
        LogisticRegression().predict_scores({"W": W}, X), dim=-1).sum(dim=0)
    assert torch.equal(soft_vote_sums_plain(X, W), chain)


@pytest.mark.parametrize("chunk_size", [None, 3])
def test_cpu_predict_proba_of_a_logistic_bag_is_the_chain_bit_for_bit(
        chunk_size):
    X, y = make_classification(200, 5, 3, seed=4)
    clf = BaggingClassifier(LogisticRegression(max_iter=2), n_estimators=7,
                            chunk_size=chunk_size, device="cpu").fit(X, y)
    before = soft_vote_quanta.launches
    got = clf.predict_proba(X)
    assert soft_vote_quanta.launches == before
    Xt = torch.from_numpy(X)
    W = clf.ensemble_["W"]
    step = clf._eff_chunk() or W.shape[0]
    sums = torch.stack([
        torch.softmax(clf.base_learner_.predict_scores(
            {"W": W[s:s + step]}, Xt), dim=-1).sum(dim=0)
        for s in range(0, W.shape[0], step)])
    np.testing.assert_array_equal(got, (sums.sum(dim=0) / 7).numpy())


def test_only_the_logistic_learner_declares_linear_softmax_scores():
    assert LogisticRegression.linear_softmax_weights == "W"
    for cls in (DecisionTreeClassifier, LinearSVC, GaussianNB, MLPClassifier):
        assert cls.linear_softmax_weights is None


@pytest.mark.parametrize("n, d, C, R, n_sm, want", [
    # the benchmark cell's chunk: 9,079 row tiles fill the card alone
    (581_012, 54, 7, 121, 132, dict(nt=1, nr=8, kp=56, nkb=1,
                                    row_tiles=9079, groups=16, gps=16,
                                    splits=1)),
    # one row: the replicas split over grid.y, a group each
    (1, 54, 7, 121, 132, dict(nt=1, nr=8, kp=56, nkb=1, row_tiles=1,
                              groups=16, gps=1, splits=16)),
    # wide X streams in k blocks; 9 classes take two n8 tiles
    (4097, 300, 9, 1001, 132, dict(nt=2, nr=4, kp=304, nkb=6,
                                   row_tiles=65, groups=251, gps=36,
                                   splits=7)),
    (17, 1, 32, 3, 132, dict(nt=4, nr=2, kp=8, nkb=1, row_tiles=1,
                             groups=2, gps=1, splits=2)),
])
def test_kernel_geometry(n, d, C, R, n_sm, want):
    assert kernel_geometry(n, d, C, R, n_sm) == want


def test_kernel_geometry_refuses_classes_above_the_limit():
    with pytest.raises(ValueError, match="classes"):
        kernel_geometry(10, 4, MAX_CLASSES + 1, 2, 132)


def test_soft_vote_sums_checks_its_inputs():
    X, W = _inputs(8, 4, 3, 2)
    with pytest.raises(ValueError):
        soft_vote_quanta(X, W[:, 1:])
    with pytest.raises(TypeError):
        soft_vote_quanta(X.double(), W)
    with pytest.raises(ValueError, match="kernel"):
        soft_vote_quanta(X, W)  # the card's only


def _fixed_point(p: np.ndarray) -> np.ndarray:
    """The kernel's fixed point of probabilities ``p`` (float32; the
    kernel's ``e q`` is ``p 2**22``): ``(..., 2)`` int64, quanta of
    2**-22 and of 2**-68. Its float steps in numpy: a fused multiply-add
    as the exact float64 value rounded once to float32, the others exact
    in float32."""
    f, d = np.float32, np.float64
    whole, magic, rest = f(2 ** 23), f(1.5 * 2 ** 23), f(2 ** 23)
    x = p.astype(d) * 2 ** 22  # e q, exact
    y0 = (x + d(whole)).astype(f)
    r0 = (x - (y0 - whole).astype(d)).astype(f)
    y1 = r0 * rest + magic
    r1 = r0 * rest - (y1 - magic)
    y2 = r1 * rest + magic
    h = [(y - m).astype(np.int64) for y, m in ((y0, whole), (y1, magic),
                                               (y2, magic))]
    return np.stack([h[0], h[1] * 2 ** 23 + h[2]], axis=-1)


@pytest.mark.parametrize("scale", [1.0, 1e-9, 1e-12, 1e-30])
def test_fixed_point_keeps_fp32_precision_and_soft_vote_mean_reads_it(scale):
    # the kernel's fixed point of each replica's probability, summed as
    # integers: within 2**-47 of it, and a probability down to ~1e-13
    # keeps fp32's relative precision (the words' rest); the mean is the
    # float64 mean's within fp32 rounding, however the replicas are split
    # into parts
    rng = np.random.default_rng(7)
    p = (scale * rng.random((40, 5, 3))).astype(np.float32)  # (R, n, C)
    q = torch.from_numpy(_fixed_point(p))
    val = (q[..., 0].double() * HI_QUANTUM + q[..., 1].double() * LO_QUANTUM)
    err = (val - torch.from_numpy(p).double()).abs()
    assert bool((err <= 2.0 ** -47).all())  # r0's one rounding
    tiny = p < 2 ** -23  # no whole quanta: fp32's own precision
    assert bool((err[tiny] <= 2.0 ** -69 + 2.0 ** -24
                 * torch.from_numpy(p[tiny]).double()).all())
    want = p.astype(np.float64).mean(axis=0)
    mean = soft_vote_mean(q.sum(dim=0)[None], n_total=40)
    assert mean.dtype == torch.float32
    if scale >= 1e-12:
        np.testing.assert_allclose(mean.numpy(), want, rtol=4e-7)
    parts = torch.stack([q[:7].sum(0), q[7:31].sum(0), q[31:].sum(0)])
    assert torch.equal(soft_vote_mean(parts, n_total=40), mean)


# -- card ----------------------------------------------------------------

def _reference(X, W, rows=32_768):
    """Float64 sums: the scores as one wide (rows, d+1) @ (d+1, R C)
    product a slice of rows, softmax over each replica's classes."""
    R, d1, C = W.shape
    W64 = W.double().permute(1, 0, 2).reshape(d1, R * C)
    out = torch.empty((X.shape[0], C), dtype=torch.float64, device=X.device)
    for s in range(0, X.shape[0], rows):
        Xb = torch.cat([X[s:s + rows].double(),
                        torch.ones((min(rows, X.shape[0] - s), 1),
                                   dtype=torch.float64, device=X.device)], 1)
        scores = (Xb @ W64).view(-1, R, C)
        out[s:s + rows] = torch.softmax(scores, dim=-1).sum(dim=1)
    return out


def _mean(X, W):
    """The kernel's mean probabilities over W's replicas, one launch."""
    return soft_vote_mean(soft_vote_quanta(X, W)[None], n_total=W.shape[0])


def _mean_gap(mean, want_sums, R) -> float:
    return float((mean.double() - want_sums / R).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("bag", ["independent", "near_equal"])
def test_kernel_at_the_cell_shapes_against_float64(cuda, bag):
    # predict.covtype_logistic: 581,012 rows, 54 features, 1000 replicas,
    # 7 classes, in the forward's chunks of 121. Independent replicas'
    # errors average away over the bag; a bag of near-equal replicas (as
    # bootstrap fits of one model are) keeps each replica's error, so it
    # is the harder case: scores of ~7 (unit weights)
    if bag == "independent":
        X, W = _inputs(581_012, 54, 7, 1000, seed=1, device=cuda)
    else:
        X, W = _inputs(581_012, 54, 7, 1, seed=1, scale=1.0, device=cuda)
        g = torch.Generator(device=cuda).manual_seed(2)
        W = W + 1e-3 * torch.randn((1000, 55, 7), generator=g, device=cuda)
    ref = _reference(X, W)
    parts = torch.stack([soft_vote_quanta(X, W[s:s + 121])
                         for s in range(0, 1000, 121)])
    got = soft_vote_mean(parts, n_total=1000)
    assert _mean_gap(got, ref, 1000) <= MEAN_TOL
    assert torch.equal(_mean(X, W), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 70_000])
def test_sums_do_not_depend_on_how_the_replicas_are_split(cuda, n):
    # each probability is summed exactly, in fixed point: the sums over
    # any partition of the replicas (chunks, grid.y splits, mesh shards)
    # add up to the same bits
    X, W = _inputs(n, 54, 7, 37, seed=4, device=cuda)
    whole = soft_vote_quanta(X, W)
    assert whole.dtype == torch.int64 and whole.shape == (n, 7, 2)
    for cut in ([1], [5, 18], [8, 16, 24, 32], list(range(1, 37))):
        bounds = [0, *cut, 37]
        parts = torch.stack([soft_vote_quanta(X, W[a:b])
                             for a, b in zip(bounds, bounds[1:])])
        assert torch.equal(parts.sum(dim=0), whole)
        assert torch.equal(soft_vote_mean(parts, n_total=37),
                           soft_vote_mean(whole[None], n_total=37))


@pytest.mark.cuda
def test_the_wrapper_sizes_the_split_images_as_the_kernel_lays_them(cuda):
    assert kernels.library().sbt_soft_vote_stage_units() == sv._STAGE_UNITS


_EDGES = list(itertools.product((1, 17, 4097), (1, 121, 1001),
                                (2, 3, 8, 9, MAX_CLASSES), (1, 54, 300)))


@pytest.mark.cuda
@pytest.mark.parametrize("n, R, C, d", _EDGES)
def test_kernel_at_edge_shapes_against_float64(cuda, n, R, C, d):
    X, W = _inputs(n, d, C, R, seed=n + R + C + d, device=cuda)
    got = _mean(X, W)
    assert got.shape == (n, C)
    assert _mean_gap(got, _reference(X, W), R) <= MEAN_TOL


@pytest.mark.cuda
def test_classes_above_the_limit_keep_the_torch_chain(cuda):
    X, W = _inputs(64, 5, MAX_CLASSES + 1, 3, device=cuda)
    with pytest.raises(ValueError, match="classes"):
        soft_vote_quanta(X, W)
    assert kernel_vote(
        LogisticRegression(), {"W": W}, None, X, MAX_CLASSES + 1, 3,
        voting="soft", identity_subspace=True) is None


@pytest.mark.cuda
@pytest.mark.parametrize("C", [2, 7, 9])
def test_kernel_keeps_scores_of_1e4_stable(cuda, C):
    # scores of +-1e4 (a softmax without its max subtracted overflows):
    # class 0 leads every replica by 100 or more, so each replica's
    # probabilities are one-hot to fp32's last bit
    rng = np.random.default_rng(C)
    R, n, d = 37, 1000, 10
    X = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    W = 0.1 * rng.standard_normal((R, d + 1, C)).astype(np.float32)
    W[:, -1, :] = rng.choice([-1e4, 1e4 - 100.0], (R, C))
    W[:, -1, 0] = 1e4
    W = torch.from_numpy(W)
    X, W = X.to(cuda), W.to(cuda)
    got = _mean(X, W)
    assert torch.isfinite(got).all()
    assert _mean_gap(got, _reference(X, W), R) <= MEAN_TOL


def _tiny_class_bag(cuda, p, n=4097, d=54, C=7, R=121, seed=11):
    """A bag of near-equal replicas (as bootstrap fits of one model are)
    in which the last class has probability ~``p`` in every replica
    and row: its bias sits ~ln(p) below the others', its weights small."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    W = 0.01 * rng.standard_normal((1, d + 1, C)) \
        + 1e-3 * rng.standard_normal((R, d + 1, C))
    W[:, -1, -1] += np.log(p * (C - 1))
    return (torch.from_numpy(X).to(cuda),
            torch.from_numpy(W.astype(np.float32)).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1e-9, 1e-12])
def test_a_tiny_class_keeps_its_size_in_every_replica(cuda, p):
    # the fixed point's rest keeps a probability of 1e-9 or 1e-12 to
    # fp32's relative precision: a class this unlikely in every replica
    # is held to float64 by relative error (quanta of 2**-22 alone voted
    # it 0 in each replica), the others as everywhere
    X, W = _tiny_class_bag(cuda, p)
    ref = _reference(X, W) / W.shape[0]
    got = _mean(X, W).double()
    tiny = ref[:, -1]
    assert float(tiny.max()) < 10 * p and float(tiny.min()) > p / 10
    rel = float(((got[:, -1] - tiny) / tiny).abs().max())
    assert rel <= TINY_REL_TOL
    assert float((got - ref).abs().max()) <= MEAN_TOL


@pytest.mark.cuda
def test_predict_log_proba_of_a_tiny_class_is_the_torch_chains(cuda):
    # predict_log_proba over the kernel's forward against the log of the
    # torch chain's mean (fp32 products, float64 log). The last class is
    # class 0 with its bias 25 lower, so its probability is class 0's
    # times e**-25 (at most 1.4e-11) in every replica: where it is 1e-13
    # or more it keeps its log, not the floor's -87.5
    X, y = make_classification(3000, 12, 4, seed=5)
    clf = BaggingClassifier(LogisticRegression(max_iter=2), n_estimators=9,
                            device=cuda).fit(X, y)
    W = clf.ensemble_["W"]
    W[..., -1] = W[..., 0]
    W[:, -1, -1] -= 25.0
    before = soft_vote_quanta.launches
    got = clf.predict_log_proba(X)
    assert soft_vote_quanta.launches == before + 1
    Xt = torch.from_numpy(X).to(cuda)
    want = torch.log(soft_vote_sums_plain(Xt, W).double() / W.shape[0])
    assert float(want[:, -1].max()) < -24.9
    gap = (torch.from_numpy(got).to(cuda).double() - want).abs()
    held = want[:, -1] >= math.log(1e-13)
    assert int(held.sum()) > X.shape[0] // 2
    assert float(gap[held, -1].max()) <= TINY_REL_TOL
    assert float(gap[:, :-1].max()) <= TINY_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 70_000])
def test_kernel_is_bitwise_repeatable_and_through_a_graph(cuda, n):
    X, W = _inputs(n, 54, 7, 121, seed=3, device=cuda)
    first = soft_vote_quanta(X, W)
    again = soft_vote_quanta(X, W)
    assert torch.equal(first, again)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        soft_vote_quanta(X, W)  # the capture's warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = soft_vote_quanta.launches
    with torch.cuda.graph(graph):
        captured = soft_vote_quanta(X, W)
    assert soft_vote_quanta.launches == before + 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


def _bag(cuda, learner, **opts):
    X, y = make_classification(3000, 12, 4, seed=5)
    return BaggingClassifier(learner, n_estimators=9, device=cuda,
                             **opts).fit(X, y), X


@pytest.mark.cuda
@pytest.mark.parametrize("case, launches", [
    # one launch a forward, whatever the replica chunk: the kernel keeps
    # no (R, n, C) scores for a chunk to bound
    ("logistic", 1), ("logistic_chunked", 1), ("hard_vote", 0),
    ("subspaced", 0), ("trees", 0)])
def test_launches_per_forward(cuda, case, launches):
    learner = (DecisionTreeClassifier(max_depth=3) if case == "trees"
               else LogisticRegression(max_iter=2))
    opts = {"logistic_chunked": {"chunk_size": 3},
            "hard_vote": {"voting": "hard"},
            "subspaced": {"max_features": 0.75},
            "trees": {"max_features": 0.75, "voting": "hard"}}.get(case, {})
    clf, X = _bag(cuda, learner, **opts)
    before = soft_vote_quanta.launches
    proba = clf.predict_proba(X)
    assert soft_vote_quanta.launches == before + launches
    assert np.allclose(proba.sum(axis=1), 1.0, atol=1e-5)
    if launches:
        # the kernel's forward against the chain it replaced, on the card
        Xt = torch.from_numpy(X).to(cuda)
        W = clf.ensemble_["W"]
        want = soft_vote_sums_plain(Xt, W).double() / W.shape[0]
        assert float((torch.from_numpy(proba).to(cuda) - want).abs().max()
                     ) <= 1e-5


@pytest.mark.cuda
def test_cpu_forward_of_a_card_fit_launches_nothing(cuda):
    clf, X = _bag(cuda, LogisticRegression(max_iter=2))
    fn, params, subs = clf.aggregated_forward()
    before = soft_vote_quanta.launches
    cpu = fn({k: v.cpu() for k, v in params.items()}, subs.cpu(),
             torch.from_numpy(X))
    assert soft_vote_quanta.launches == before
    card = fn(params, subs, torch.from_numpy(X).to(cuda))
    assert soft_vote_quanta.launches == before + 1
    assert float((card.cpu() - cpu).abs().max()) <= 1e-5
