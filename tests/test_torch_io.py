"""The data plane of the port against the JAX package's: the file readers
(``LibsvmChunks``, ``CSVChunks``, ``HashedCSVChunks``, ``ArrowChunks``),
the whole-file parsers, the hasher, the dataset registry with BASELINE
config 1, ``synthetic_criteo``, ``f1_score``, the zstd resolution, and
``utils/profiling.py`` / ``utils/debug.py`` with the ``fit_report_``'s
MFU keys.

Host numpy code, copied: every array is held bitwise, on the host
loader's native path (the g++-built ``native/loader.cpp``) and on the
pure-Python path (the loader's ``get_lib`` forced to None in both
packages). Files hold a few hundred rows. Config 1's fits are held to
the logistic tolerance of tests/test_torch_bagging.py (probabilities
within 1e-5) and their test accuracies equal.
"""

import os
import warnings

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import spark_bagging_tpu as J  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu.utils import datasets as jds  # noqa: E402
from spark_bagging_tpu.utils import hashing as jhash  # noqa: E402
from spark_bagging_tpu.utils import io as jio  # noqa: E402
from spark_bagging_tpu.utils import metrics as jmetrics  # noqa: E402
from spark_bagging_tpu.utils import native as jnative  # noqa: E402
from spark_bagging_tpu_torch.utils import datasets as tds  # noqa: E402
from spark_bagging_tpu_torch.utils import debug as tdebug  # noqa: E402
from spark_bagging_tpu_torch.utils import hashing as thash  # noqa: E402
from spark_bagging_tpu_torch.utils import host_native  # noqa: E402
from spark_bagging_tpu_torch.utils import io as tio  # noqa: E402
from spark_bagging_tpu_torch.utils import metrics as tmetrics  # noqa: E402
from spark_bagging_tpu_torch.utils import profiling as tprof  # noqa: E402

PROBA_ATOL = 1e-5
PATHS = ("native", "python")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/test_torch_stream.py explains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=PATHS)
def path_kind(request, monkeypatch):
    """Both packages on the native path (the host loader must build
    here: g++ is present) or both on the pure-Python parsers."""
    if request.param == "python":
        monkeypatch.setattr(host_native, "get_lib", lambda: None)
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
    else:
        assert host_native.get_lib() is not None, "the host loader must build"
    return request.param


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A libsvm file (comments, blank lines, sparse rows, a zero-based
    twin), a CSV with a header and blank lines, a plain CSV, and a
    hashed CSV with categorical columns, all of 150 rows."""
    d = tmp_path_factory.mktemp("readers")
    rng = np.random.default_rng(5)
    n, F = 150, 6
    X = rng.standard_normal((n, F)).astype(np.float32)
    y = rng.integers(0, 3, n).astype(np.float32)
    out = {"X": X, "y": y}
    for name, base in (("svm", 1), ("svm0", 0)):
        p = d / f"a.{name}"
        with open(p, "w") as f:
            f.write("# a comment line\n\n")
            for i in range(n):
                feats = " ".join(f"{j + base}:{X[i, j]:.9g}"
                                 for j in range(F) if (i + j) % 3)
                f.write(f"{y[i]:.9g} {feats}  # trailing\n")
        out[name] = str(p)
    p = d / "header.csv"
    with open(p, "w") as f:
        f.write("\n" + ",".join(f"f{j}" for j in range(F)) + ",label\n")
        for i in range(n):
            f.write(",".join(f"{v:.9g}" for v in X[i]) + f",{y[i]:.9g}\n")
            if i % 40 == 0:
                f.write("\n")
    out["header_csv"] = str(p)
    p = d / "plain.csv"
    np.savetxt(p, np.c_[y, X], fmt="%.9g", delimiter=",")
    out["plain_csv"] = str(p)
    cats = np.char.add("v", rng.zipf(1.6, (n, 3)).astype(str))
    cats[::17, 1] = ""  # empty categorical fields are tokens too
    p = d / "hashed.csv"
    with open(p, "w") as f:
        f.write("label,n0,n1,c0,c1,c2\n")
        for i in range(n):
            n1 = "" if i % 11 == 0 else f"{X[i, 1]:.9g}"  # empty -> 0
            f.write(f"{y[i]:.9g},{X[i, 0]:.9g},{n1},"
                    + ",".join(cats[i]) + "\n")
    out["hashed_csv"] = str(p)
    return out


def assert_chunks_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for (gx, gy, gn), (wx, wy, wn) in zip(got, want):
        assert gn == wn
        assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


READERS = {
    "libsvm": lambda m, f: m.LibsvmChunks(f["svm"], 6, 64),
    "libsvm_zero_based": lambda m, f: m.LibsvmChunks(
        f["svm0"], 6, 64, zero_based=True),
    "libsvm_narrow_n_rows": lambda m, f: m.LibsvmChunks(
        f["svm"], 4, 50, n_rows=150),
    "csv_header_blank_lines": lambda m, f: m.CSVChunks(
        f["header_csv"], 64, skip_header=True),
    "csv_label_first": lambda m, f: m.CSVChunks(
        f["plain_csv"], 40, label_col=0),
    "csv_n_rows_given": lambda m, f: m.CSVChunks(
        f["plain_csv"], 64, label_col=0, n_rows=150),
}


@pytest.mark.parametrize("reader", sorted(READERS))
def test_reader_chunks_bitwise_jax(reader, files, path_kind):
    before = dict(host_native.served)
    src_t, src_j = READERS[reader](tio, files), READERS[reader](jio, files)
    assert (src_t.n_rows, src_t.n_features, src_t.n_chunks) == (
        src_j.n_rows, src_j.n_features, src_j.n_chunks)
    assert_chunks_equal(src_t.chunks(), src_j.chunks())
    assert_chunks_equal(src_t.chunks_from(2), src_j.chunks_from(2))
    assert host_native.served[path_kind] > before[path_kind]
    other = "python" if path_kind == "native" else "native"
    assert host_native.served[other] == before[other]


def test_csv_chunks_are_the_array_chunks_of_the_same_rows(files):
    """Text written with %.9g round-trips float32 exactly, so a CSV
    stream is bitwise the ArrayChunks stream of the rows it holds."""
    X, y = files["X"], files["y"]
    assert_chunks_equal(tio.CSVChunks(files["plain_csv"], 64, label_col=0)
                        .chunks(), tio.ArrayChunks(X, y, 64).chunks())


@pytest.mark.parametrize("kw", [dict(), dict(n_features=4),
                                dict(zero_based=True)])
def test_parse_libsvm_matches_jax(files, path_kind, kw):
    path = files["svm0" if kw.get("zero_based") else "svm"]
    for got, want in zip(tds.parse_libsvm(path, **kw),
                         jds.parse_libsvm(path, **kw)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,kw", [
    ("header_csv", dict(skip_header=True)),
    ("plain_csv", dict(label_col=0)),
])
def test_load_csv_matches_jax(files, path_kind, name, kw):
    for got, want in zip(tds.load_csv(files[name], **kw),
                         jds.load_csv(files[name], **kw)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_float_parsing_native_matches_python(tmp_path):
    """``loader.cpp``'s strtof and Python's float()→float32 agree bit for
    bit, over random bit patterns written with %.9g and with %.6g."""
    rng = np.random.default_rng(11)
    v = rng.integers(0, 2**32, 600, dtype=np.uint64).astype(np.uint32)
    vals = v.view(np.float32)
    vals = vals[np.isfinite(vals)][:500].reshape(100, 5)
    for fmt in ("%.9g", "%.6g"):
        p = tmp_path / f"f{fmt[2]}.csv"
        np.savetxt(p, vals, fmt=fmt, delimiter=",")
        Xn, yn = tds.load_csv(str(p))
        want = np.array([[np.float32(float(fmt % x)) for x in row]
                         for row in vals])
        np.testing.assert_array_equal(np.c_[Xn, yn], want)


def test_reader_errors_match_jax(files, tmp_path, path_kind):
    with pytest.raises(ValueError) as et:
        tio.CSVChunks(files["plain_csv"], 10, label_col=9)
    with pytest.raises(ValueError) as ej:
        jio.CSVChunks(files["plain_csv"], 10, label_col=9)
    assert str(et.value) == str(ej.value)
    bad = tmp_path / "bad.svm"
    bad.write_text("1 qid:3 1:0.5\n")
    if path_kind == "python":
        with pytest.raises(ValueError) as et:
            tds.parse_libsvm(str(bad))
        with pytest.raises(ValueError) as ej:
            jds.parse_libsvm(str(bad))
        assert str(et.value) == str(ej.value)


def test_host_loader_builds_into_build_dir_only():
    lib = host_native.get_lib()
    assert lib is not None
    path = host_native.library_path()
    assert os.path.dirname(path) == host_native.BUILD_DIR
    assert os.path.basename(path).startswith("libsbt_loader_")
    assert os.path.exists(path)
    native_dir = os.path.join(os.path.dirname(host_native.BUILD_DIR),
                              "native")
    assert sorted(os.listdir(native_dir)) == ["loader.cpp"]


# -- hashing ------------------------------------------------------------

@pytest.mark.parametrize("seed,width", [(0, 16), (7, 1024)])
def test_feature_hasher_bitwise_jax(seed, width):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, 40, 200).astype(str),
            np.array([f"x{v}" for v in rng.zipf(1.4, 200)], dtype=object),
            rng.integers(-5, 5, 200)]
    got = thash.FeatureHasher(width, seed).transform_columns(cols)
    want = jhash.FeatureHasher(width, seed).transform_columns(cols)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_feature_hasher_errors_match_jax():
    for args, call in (((1,), None), ((8,), [])):
        with pytest.raises(ValueError) as et:
            h = thash.FeatureHasher(*args)
            h.transform_columns(call)
        with pytest.raises(ValueError) as ej:
            h = jhash.FeatureHasher(*args)
            h.transform_columns(call)
        assert str(et.value) == str(ej.value)


def test_hashed_csv_chunks_bitwise_jax(files, path_kind):
    kw = dict(chunk_rows=64, label_col=0, numeric_cols=[1, 2],
              categorical_cols=[3, 4, 5], n_hash=32, seed=3,
              skip_header=True)
    src_t = thash.HashedCSVChunks(files["hashed_csv"], **kw)
    src_j = jhash.HashedCSVChunks(files["hashed_csv"], **kw)
    assert (src_t.n_rows, src_t.n_features) == (src_j.n_rows,
                                                src_j.n_features) == (150, 34)
    assert_chunks_equal(src_t.chunks(), src_j.chunks())


def test_hashed_csv_native_equals_python(files, monkeypatch):
    kw = dict(chunk_rows=50, label_col=0, numeric_cols=[1, 2],
              categorical_cols=[3, 4, 5], n_hash=64, skip_header=True)
    native = list(thash.HashedCSVChunks(files["hashed_csv"], **kw).chunks())
    monkeypatch.setattr(host_native, "get_lib", lambda: None)
    assert_chunks_equal(
        native, thash.HashedCSVChunks(files["hashed_csv"], **kw).chunks())


# -- Arrow ----------------------------------------------------------------

@pytest.fixture(scope="module")
def arrow_files(tmp_path_factory):
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    d = tmp_path_factory.mktemp("arrow")
    rng = np.random.default_rng(9)
    X = rng.standard_normal((130, 4)).astype(np.float32)
    y = rng.integers(0, 2, 130)
    ipc = str(d / "rows.arrow")
    out = {"ipc": ipc}
    from spark_bagging_tpu_torch.utils.arrow import write_row_major_ipc

    write_row_major_ipc(ipc, X, y, chunk_rows=30, label_dtype=np.int64)
    table = pa.table({**{f"f{j}": X[:, j] for j in range(4)}, "target": y})
    pq_path = str(d / "cols.parquet")
    pq.write_table(table, pq_path, row_group_size=40)
    out["parquet"] = pq_path
    out["X"], out["y"] = X, y
    return out


@pytest.mark.parametrize("kind,kw", [
    ("ipc", dict()),
    ("parquet", dict(label_col="target")),
    ("parquet", dict(label_col=-1, columns=["f0", "f2", "target"])),
])
def test_arrow_bitwise_jax(arrow_files, kind, kw):
    from spark_bagging_tpu.utils import arrow as jarrow
    from spark_bagging_tpu_torch.utils import arrow as tarrow

    path = arrow_files[kind]
    for got, want in zip(tarrow.load_arrow(path, **kw),
                         jarrow.load_arrow(path, **kw)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    src_t = T.ArrowChunks(path, 25, **kw)
    src_j = J.ArrowChunks(path, 25, **kw)
    assert (src_t.n_rows, src_t.n_features) == (src_j.n_rows,
                                                src_j.n_features)
    assert_chunks_equal(src_t.chunks(), src_j.chunks())
    assert_chunks_equal(src_t.chunks_from(3), src_j.chunks_from(3))


def test_arrow_errors_match_jax(arrow_files):
    from spark_bagging_tpu.utils import arrow as jarrow
    from spark_bagging_tpu_torch.utils import arrow as tarrow

    for kw in (dict(label_col="nope"), dict(label_col=9),
               dict(columns=["zz"])):
        with pytest.raises(ValueError) as et:
            tarrow.load_arrow(arrow_files["parquet"], **kw)
        with pytest.raises(ValueError) as ej:
            jarrow.load_arrow(arrow_files["parquet"], **kw)
        assert str(et.value) == str(ej.value)


# -- datasets, metrics, codecs ----------------------------------------------

@pytest.mark.parametrize("kw", [dict(n_rows=300, n_features=64),
                                dict(n_rows=200, n_features=16, seed=4,
                                     structure_seed=13)])
def test_synthetic_criteo_bitwise_jax(kw):
    for got, want in zip(tds.synthetic_criteo(**kw),
                         jds.synthetic_criteo(**kw)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_dataset_registry_matches_jax(files):
    assert sorted(tds._REGISTRY) == sorted(jds._REGISTRY)
    for name in ("breast_cancer", "iris"):
        for got, want in zip(tds.load_dataset(name), jds.load_dataset(name)):
            np.testing.assert_array_equal(got, want)
    for got, want in zip(tds.load_dataset(files["plain_csv"], label_col=0),
                         jds.load_dataset(files["plain_csv"], label_col=0)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(KeyError) as et:
        tds.load_dataset("no_such_set")
    with pytest.raises(KeyError) as ej:
        jds.load_dataset("no_such_set")
    assert str(et.value) == str(ej.value)


def test_config_1_breast_cancer_matches_jax():
    """BASELINE config 1 (benchmarks/run_configs.py:138-181): 10 bagged
    LogisticRegression(max_iter=20, l2=1e-3), seed 0, on the
    standardized breast-cancer split, in both packages."""
    X, y = tds.load_dataset("breast_cancer")
    Xtr, ytr, Xte, yte = tds.train_test_split(tds.standardize(X), y)
    tc = T.BaggingClassifier(T.LogisticRegression(max_iter=20, l2=1e-3),
                             n_estimators=10, seed=0, device="cpu")
    jc = J.BaggingClassifier(J.LogisticRegression(max_iter=20, l2=1e-3),
                             n_estimators=10, seed=0)
    tc.fit(Xtr, ytr)
    jc.fit(Xtr, ytr)
    assert tc.score(Xte, yte) == jc.score(Xte, yte)
    assert tc.score(Xte, yte) >= 0.94
    np.testing.assert_allclose(tc.predict_proba(Xte), jc.predict_proba(Xte),
                               atol=PROBA_ATOL, rtol=0)


@pytest.mark.parametrize("average", ["weighted", "macro"])
def test_f1_score_matches_jax(average):
    rng = np.random.default_rng(2)
    yt, yp = rng.integers(0, 4, 300), rng.integers(0, 5, 300)
    assert tmetrics.f1_score(yt, yp, average) == jmetrics.f1_score(
        yt, yp, average)
    with pytest.raises(ValueError) as et:
        tmetrics.f1_score(yt, yp, "micro")
    with pytest.raises(ValueError) as ej:
        jmetrics.f1_score(yt, yp, "micro")
    assert str(et.value) == str(ej.value)


def test_optional_zstd_and_one_time_warning(monkeypatch):
    zstd = pytest.importorskip("zstandard")
    assert tio.optional_zstd() is zstd is jio.optional_zstd()
    monkeypatch.setattr(tio, "_WARNED_NO_ZSTD", False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tio.warn_zstd_fallback("a test")
        tio.warn_zstd_fallback("a test")
    assert len(caught) == 1
    assert "a test falls back to the stdlib zlib codec" in str(
        caught[0].message)


# -- profiling, debug, the fit report ----------------------------------------

def test_fit_report_keys_match_jax():
    """The logistic headline's learner on the CPU: the same key set, and
    ``mfu`` None in both (no peak for a CPU)."""
    X, y = tds.make_classification(300, 6, 3, seed=2)
    kw = dict(max_iter=2, init="pooled", hessian_impl="pallas")
    tc = T.BaggingClassifier(T.LogisticRegression(**kw), n_estimators=4,
                             device="cpu").fit(X, y)
    jc = J.BaggingClassifier(J.LogisticRegression(**kw),
                             n_estimators=4).fit(X, y)
    assert set(tc.fit_report_) == set(jc.fit_report_)
    assert tc.fit_report_["peak_tflops_bf16"] is None
    assert tc.fit_report_["mfu"] is None is jc.fit_report_["mfu"]
    assert tc.fit_report_["achieved_tflops"] > 0


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989.4), ("NVIDIA H100 NVL", 835.5),
    ("NVIDIA H100 PCIe", 756.5), ("NVIDIA H100 SXM5 80GB", 989.4),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_device_peak_tflops_by_card_name(monkeypatch, name, peak):
    assert tprof.device_peak_tflops("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert tprof.device_peak_tflops("cuda") == peak


def test_profile_single_flight(tmp_path):
    with tprof.trace(str(tmp_path / "a")):
        assert tprof.profile_active()["dir"] == str(tmp_path / "a")
        with pytest.raises(tprof.ProfilerBusy):
            tprof.start_profile(str(tmp_path / "b"))
        torch.ones(8).sum()
    assert tprof.profile_active() is None
    assert os.path.exists(tmp_path / "a" / "trace.json")
    assert tprof.stop_profile() is None
    with pytest.raises(ValueError):
        tprof.start_profile(max_seconds=0)
    with tprof.log_timing("a phase"):
        pass


def test_debug_mode_checks_bootstrap_weights():
    assert not tdebug.debug_active()
    tdebug.check_bootstrap_weights(torch.tensor([[-1.0]]))  # off: no-op
    with tdebug.debug_mode():
        assert tdebug.debug_active() and torch.is_anomaly_enabled()
        with pytest.raises(AssertionError, match="finite and >= 0"):
            tdebug.check_bootstrap_weights(torch.tensor([[1.0, -1.0]]))
        X, y = tds.make_classification(100, 4, 2, seed=0)
        T.BaggingClassifier(T.LogisticRegression(max_iter=2),
                            n_estimators=3, device="cpu").fit(X, y)
    assert not tdebug.debug_active() and not torch.is_anomaly_enabled()
