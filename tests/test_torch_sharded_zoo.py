"""The data axis of the eight learner families threaded last (GBT, MLP,
LinearSVC, GLM, FM, AFT, naive Bayes and isotonic) against the JAX
package's mesh fits on its 8-device CPU mesh.

The port's mesh is ``[torch.device("cpu")] * 8``, each shard a thread.
Every (2, 4) case fits the same numpy data with the same seed in both
packages: each data shard draws its rows' weights from ``fold_in(key,
shard)`` (bitwise JAX's, tests/test_torch_sharded.py), the learners sum
their row statistics over ``data`` and the votes over ``replica``. Each
family is held to its single-device parity tolerance
(tests/test_torch_zoo_*.py, tests/test_torch_mlp.py,
tests/test_torch_gbt.py), from the family's own docstring:

- MLP and FM (Adam): parameters and probabilities within ``ADAM_TOL``
  1e-5; AFT (Adam on a likelihood) within ``AFT_TOL`` 2e-4, against
  JAX's single-device learner on the mesh's draws (below);
- LinearSVC: coefficients within ``SVC_W_TOL`` 5e-3, probabilities
  within ``SVC_PROBA_TOL`` 1e-4; GLM within ``GLM_TOL`` 5e-4;
- naive Bayes and isotonic: parameters within 1e-5;
- GBTs: splits equal and leaves within 1e-5 outside ties between
  equally good splits (at most ``MAX_TIE_SHARE`` of the nodes, as
  tests/test_torch_gbt.py leaves them out), predictions within 1e-5 on
  the rows every replica trained on.

The ``bootstrap=False`` (8, 1) cases need no JAX compile: every weight
is 1, so the mesh fit is the port's single-device fit on the same rows
within the same tolerances (GBTs: ties left out, as against JAX: the
mesh sums each level's float table over the shards). GBT and isotonic
bin with the shards' averaged quantiles (JAX's semantics), so their
single-device fit is made under the mesh's edges.

AFT is the one family whose JAX mesh fit is not the JAX single-device
fit on the same weights: its objective puts the ``psum`` inside the
function it differentiates, and the ``shard_map`` runs with
``check_vma=False``, so each shard steps on its own rows' gradient
times the shard count (at ``bootstrap=False`` on 248 rows, replica 0's
``beta`` from JAX's (2, 4) and (8, 1) fits differs from its
single-device fit by up to 0.060 and 0.092, which its ``data=1`` mesh
matches to the bit). The port sums the gradients
over ``data``, so its (2, 4) fit is held to JAX's learner fitted on one
device with the mesh's weights: each replica's rows drawn shard by
shard from ``fold_in(key, shard)``, its subspace and fit key JAX's.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import spark_bagging_tpu as J  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu.parallel.compat import shard_map as jshard_map  # noqa: E402
from spark_bagging_tpu_torch.ops import prng  # noqa: E402
from spark_bagging_tpu_torch.parallel import compat  # noqa: E402
from spark_bagging_tpu_torch.parallel.compat import P  # noqa: E402
from spark_bagging_tpu_torch.utils import datasets as tdata  # noqa: E402

ADAM_TOL = 1e-5
AFT_TOL = 2e-4
SVC_W_TOL = 5e-3
SVC_PROBA_TOL = 1e-4
GLM_TOL = 5e-4
NB_TOL = 1e-5
ISO_TOL = 1e-5
GBT_TOL = 1e-5
MAX_TIE_SHARE = 0.1
CPU8 = [torch.device("cpu")] * 8
# 250 rows: a (2, 4) mesh splits them 125 a shard, no padding; the
# (8, 1) cases take the first 248
N = 250
EST = dict(n_estimators=8, seed=0, max_features=0.8)
GBT = dict(n_rounds=3, max_depth=3, n_bins=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the mesh's shard threads are the parallelism
    here, and xdist workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tmesh(data):
    return T.make_mesh(data, devices=CPU8)


def jmesh(data):
    return J.make_mesh(data)


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3g} > {tol} x {scale:.3g}"


def _clf_data(C=3):
    return tdata.make_classification(N, 6, C, seed=1, class_sep=0.8)


def _reg_data():
    return tdata.make_regression(N, 5, seed=2)


def _survival_data():
    X, y = _reg_data()
    t = np.exp(0.3 * y / np.abs(y).max()).astype(np.float32)
    delta = (np.arange(N) % 3 != 0).astype(np.float32)  # a third censored
    return X, t, delta


def _pair(mod_name, learner_kw):
    """The same learner of both packages."""
    return (getattr(J, mod_name)(**learner_kw),
            getattr(T, mod_name)(**learner_kw))


def _fit_mesh(task, name, kw, X, y, data=2, fit_kw=None, est=None):
    """``(JAX fit, port fit)`` on a ``data``-row mesh of 8 devices."""
    jl, tl = _pair(name, kw)
    est = {**EST, **(est or {})}
    fit_kw = fit_kw or {}
    JE, TE = ((J.BaggingClassifier, T.BaggingClassifier) if task == "clf"
              else (J.BaggingRegressor, T.BaggingRegressor))
    jf = JE(jl, mesh=jmesh(data), **est).fit(X, y, **fit_kw)
    tf = TE(tl, mesh=tmesh(data), device="cpu", **est).fit(X, y, **fit_kw)
    return jf, tf


def _out(est, X):
    return (est.predict_proba(X) if hasattr(est, "predict_proba")
            else est.predict(X))


# -- every family on a (2, 4) mesh against JAX's mesh fit ---------------

ZOO = {
    "mlp": ("clf", "MLPClassifier", dict(hidden=8, max_iter=10, lr=0.05),
            ADAM_TOL, ADAM_TOL),
    "svc": ("clf", "LinearSVC", dict(max_iter=5), SVC_W_TOL, SVC_PROBA_TOL),
    "fm": ("clf", "FMClassifier", dict(max_iter=10), ADAM_TOL, ADAM_TOL),
    "gaussian_nb": ("clf", "GaussianNB", {}, NB_TOL, NB_TOL),
    "multinomial_nb": ("clf", "MultinomialNB", {}, NB_TOL, NB_TOL),
    "bernoulli_nb": ("clf", "BernoulliNB", {}, NB_TOL, NB_TOL),
    "glm": ("reg", "GeneralizedLinearRegression", dict(max_iter=5),
            GLM_TOL, GLM_TOL),
    "isotonic": ("reg", "IsotonicRegression", dict(n_bins=32), ISO_TOL,
                 ISO_TOL),
}
AFT = dict(max_iter=20)


def _zoo_data(name):
    task = "reg" if name == "aft" else ZOO[name][0]
    if name == "aft":
        X, t, delta = _survival_data()
        return X, t, {"aux": delta}
    if task == "reg":
        X, y = _reg_data()
        return X, y, {}
    X, y = _clf_data()
    if name == "multinomial_nb":
        X = np.abs(X)  # counts
    return X, y, {}


# one learner of each family against JAX (the three naive Bayes fits
# share their class-weighted sums, ``_weighted_class_counts``; all three
# run on the (8, 1) mesh below)
@pytest.mark.parametrize("name", sorted(set(ZOO) - {"multinomial_nb",
                                                    "bernoulli_nb"}))
def test_family_on_a_2x4_mesh_matches_jax(name):
    task, cls, kw, param_tol, out_tol = ZOO[name]
    X, y, fit_kw = _zoo_data(name)
    jf, tf = _fit_mesh(task, cls, kw, X, y, fit_kw=fit_kw)
    np.testing.assert_array_equal(tf.subspaces_.numpy(),
                                  np.asarray(jf.subspaces_))
    for k, v in tf.ensemble_.items():
        _close(v.numpy(), np.asarray(jf.ensemble_[k]), param_tol, k)
    _close(_out(tf, X), _out(jf, X), out_tol, "output")
    assert tf.fit_report_["n_devices"] == 8


def _jax_aft_on_mesh_draws(X, t, delta, data):
    """JAX's AFT learner fitted on one device, replica by replica, on
    the weights a ``data``-row mesh draws (each shard's rows from
    ``fold_in(key, shard)``), with JAX's subspaces and fit keys."""
    import jax.numpy as jnp
    from spark_bagging_tpu.ops.bootstrap import (
        bootstrap_weights_one,
        feature_subspace_one,
        fit_key,
    )

    learner = J.AFTSurvivalRegression(**AFT)
    key = jax.random.key(EST["seed"])
    n_feat = X.shape[1]
    n_sub = max(1, min(n_feat, round(EST["max_features"] * n_feat)))
    Xj, tj, dj = jnp.asarray(X), jnp.asarray(t), jnp.asarray(delta)

    def one(rid):
        w = jnp.concatenate([
            bootstrap_weights_one(jax.random.fold_in(key, i), rid,
                                  X.shape[0] // data)
            for i in range(data)])
        idx = feature_subspace_one(key, rid, n_feat, n_sub)
        params, _ = learner.fit_from_init(fit_key(key, rid), Xj[:, idx], tj,
                                          w, 1, aux=dj)
        return params

    return jax.vmap(one)(jnp.arange(EST["n_estimators"]))


def test_aft_on_a_2x4_mesh_matches_jax_on_the_mesh_draws():
    X, t, delta = _survival_data()
    tf = T.BaggingRegressor(T.AFTSurvivalRegression(**AFT), mesh=tmesh(2),
                            device="cpu", **EST).fit(X, t, aux=delta)
    want = _jax_aft_on_mesh_draws(X, t, delta, 2)
    for k, v in tf.ensemble_.items():
        _close(v.numpy(), np.asarray(want[k]), AFT_TOL, k)
    assert tf.fit_report_["n_devices"] == 8


def _untied(jp, tp, depth):
    """Masks of the nodes ``(R, trees·M)`` and leaves ``(R, trees, L)``
    outside ties between equally good splits, and below none
    (tests/test_torch_gbt.py)."""
    M, L = 2**depth - 1, 2**depth
    R = jp["gain"].shape[0]
    scale = np.maximum(np.abs(jp["gain"]).max(axis=1, keepdims=True), 1.0)
    differ = ((jp["feature"] != tp["feature"])
              | (jp["threshold"] != tp["threshold"]))
    tie = differ & (np.abs(jp["gain"] - tp["gain"]) <= GBT_TOL * scale)
    bad = tie.reshape(R, -1, M).copy()
    for lv in range(1, depth):
        for r in range(2**lv):
            node, parent = 2**lv - 1 + r, 2**(lv - 1) - 1 + r // 2
            bad[..., node] |= bad[..., parent]
    leaf_parent = 2**(depth - 1) - 1 + np.arange(L) // 2
    return ~bad.reshape(R, -1), ~bad[..., leaf_parent]


def _assert_gbts_match(jp, tp):
    """Splits equal and gains, leaves and ``f0`` within ``GBT_TOL``
    outside ties; True where no node tied."""
    depth = GBT["max_depth"]
    nodes, leaves = _untied(jp, tp, depth)
    assert nodes.mean() >= 1 - MAX_TIE_SHARE, nodes.mean()
    for k in ("feature", "threshold"):
        np.testing.assert_array_equal(tp[k][nodes], jp[k][nodes], err_msg=k)
    _close(tp["gain"][nodes], jp["gain"][nodes], GBT_TOL, "gain")
    leaf_j = jp["leaf"].reshape(jp["leaf"].shape[0], -1, 2**depth)
    _close(tp["leaf"].reshape(leaf_j.shape)[leaves], leaf_j[leaves],
           GBT_TOL, "leaf")
    _close(tp["f0"], jp["f0"], GBT_TOL, "f0")
    return bool(nodes.all())


def test_gbt_on_a_2x4_mesh_matches_jax():
    """The binary GBT with row subsampling (each shard draws its own
    rows' keep mask); the multiclass and regressor engines run on the
    (8, 1) mesh below."""
    X, y = _clf_data(2)
    jf, tf = _fit_mesh("clf", "GBTClassifier", {**GBT, "subsample": 0.8},
                       X, y)
    untied = _assert_gbts_match(
        {k: np.asarray(v) for k, v in jf.ensemble_.items()},
        {k: v.numpy() for k, v in tf.ensemble_.items()})
    if untied:
        _close(_out(tf, X), _out(jf, X), GBT_TOL, "output")


def test_gbt_row_masks_on_a_data_mesh_are_jax_masks():
    """Stochastic GBT on a data mesh: shard i's keep mask is drawn from
    ``fold_in(fold_in(key_m, 0x5B), i)``, bitwise JAX's
    ``_round_row_mask`` inside its shard_map."""
    n = 40
    jl = J.GBTClassifier(subsample=0.6)
    tl = T.GBTClassifier(subsample=0.6)
    jkey = jax.random.fold_in(jax.random.key(5), 2)
    want = jshard_map(lambda k: jl._round_row_mask(k, n, "data"),
                      mesh=jmesh(8), in_specs=(JP(),),
                      out_specs=JP("data"), check_vma=False)(jkey)
    tkey = prng.fold_in(prng.key(5), 2)
    got = compat.shard_map(
        lambda k: tl._round_row_mask(k[None], n, "data")[0],
        mesh=tmesh(8), in_specs=(P(),), out_specs=P("data"))(tkey)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the shards draw different rows' masks
    assert not torch.equal(got[:n], got[n:2 * n])


# -- bootstrap=False on (8, 1): the port's own single-device fit ---------

def _mesh_prepared(learner, X):
    """The learner's prepared state on an (8, 1) mesh (the shards'
    averaged quantiles), as shard 0 holds it."""
    return compat.shard_map(
        lambda Xs: learner.prepare(Xs, axis_name="data"),
        mesh=tmesh(8), in_specs=(P("data", None),), out_specs=P())(
        torch.from_numpy(X))


EXACT = {
    **ZOO,
    "aft": ("reg", "AFTSurvivalRegression", AFT, AFT_TOL, AFT_TOL),
    "gbt": ("clf", "GBTClassifier", dict(GBT), GBT_TOL, GBT_TOL),
    "gbt_regression": ("reg", "GBTRegressor", dict(GBT), GBT_TOL, GBT_TOL),
}


@pytest.mark.parametrize("name", sorted(EXACT))
def test_deterministic_weights_on_an_8x1_mesh_are_the_single_device_fit(
        name, monkeypatch):
    task, cls, kw, param_tol, out_tol = EXACT[name]
    if name.startswith("gbt"):
        X, y = _clf_data(3) if task == "clf" else _reg_data()
        fit_kw = {}
    else:
        X, y, fit_kw = _zoo_data(name)
    n = (N // 8) * 8
    X, y = X[:n], y[:n]
    fit_kw = {k: v[:n] for k, v in fit_kw.items()}
    est = dict(n_estimators=8, seed=0, bootstrap=False, max_samples=1.0)
    E = T.BaggingClassifier if task == "clf" else T.BaggingRegressor
    learner_cls = getattr(T, cls)
    on_mesh = E(learner_cls(**kw), mesh=tmesh(8), device="cpu",
                **est).fit(X, y, **fit_kw)
    if name.startswith("gbt") or name == "isotonic":
        # the single-device fit under the mesh's edges
        mesh_prep = _mesh_prepared(learner_cls(**kw), X)
        if name == "isotonic":
            monkeypatch.setattr(learner_cls, "prepare",
                                lambda self, Xp, **_: mesh_prep)
        else:
            monkeypatch.setattr(
                learner_cls, "prepare",
                lambda self, Xp, **_: self._binned(Xp, mesh_prep["edges"]))
    single = E(learner_cls(**kw), device="cpu", **est).fit(X, y, **fit_kw)
    if name.startswith("gbt"):
        # the level tables are float sums in another order: ties aside
        _assert_gbts_match(
            {k: v.numpy() for k, v in single.ensemble_.items()},
            {k: v.numpy() for k, v in on_mesh.ensemble_.items()})
        return
    for k, v in on_mesh.ensemble_.items():
        got, want = v.numpy(), single.ensemble_[k].numpy()
        if k in ("feature", "threshold"):
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            _close(got, want, param_tol, k)
    _close(_out(on_mesh, X), _out(single, X), out_tol, "output")
