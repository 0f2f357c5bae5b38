"""The port's scaled-Gram op (spark_bagging_tpu_torch/ops/gram.py).

On the CPU the wrapper computes the plain torch version, held here
against the JAX package's Pallas kernel in interpret mode. The CUDA
kernel runs only on the card (tests/test_torch_cuda.py and
chip_smoke.py); its launch geometry is pure arithmetic and is checked
here by replaying the kernel's tile decode.
"""

import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from spark_bagging_tpu.ops.gram import scaled_grams as jax_scaled_grams  # noqa: E402
from spark_bagging_tpu_torch.ops import gram  # noqa: E402
from spark_bagging_tpu_torch.ops.gram import (  # noqa: E402
    kernel_geometry,
    scaled_grams,
)

# fp32 sums of the same products in another order (einsum vs the Pallas
# interpreter's 512-row tiles, or another batch blocking): the error is
# a few ulps of the largest entry, so it is measured against that scale
TOL = 1e-6


def assert_close_to_scale(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max error {err:.3g} of the largest entry > {tol}"


def _inputs(n=700, d=9, P=6, R=None, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    shape = (n, P) if R is None else (R, n, P)
    S = rng.uniform(-0.3, 1.0, shape).astype(np.float32)
    return X, S


def test_plain_matches_jax_pallas_interpret():
    X, S = _inputs()
    want = np.asarray(jax_scaled_grams(
        jnp.asarray(X), jnp.asarray(S), op_dtype="float32", interpret=True
    ))
    got = scaled_grams(torch.from_numpy(X), torch.from_numpy(S)).numpy()
    assert got.shape == (6, 9, 9)
    assert_close_to_scale(got, want)


def test_replica_batched_equals_per_replica_loop():
    X, S = _inputs(R=3)
    Xt, St = torch.from_numpy(X), torch.from_numpy(S)
    batched = scaled_grams(Xt, St)
    assert batched.shape == (3, 6, 9, 9)
    for r in range(3):
        assert_close_to_scale(batched[r], scaled_grams(Xt, St[r].contiguous()))


def test_per_replica_X():
    X, S = _inputs(R=2)
    X3 = np.stack([X, 2 * X])
    got = scaled_grams(torch.from_numpy(X3), torch.from_numpy(S))
    assert_close_to_scale(
        got[1], 4 * scaled_grams(torch.from_numpy(X),
                                 torch.from_numpy(S[1].copy())),
    )


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round float32 to bfloat16 (nearest even), back as float32."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def test_bf16_mode_matches_numpy_emulation():
    # JAX's interpreter computes bf16 operands in f32 (gram.py), so it
    # cannot be the reference here: numpy rounds X and x*s to bf16, sums
    # their exact products in float64 as the TPU kernel pairs them
    # (x_i with x_j*s) and keeps the upper triangle, as the CUDA kernel
    X, S = _inputs(R=2)
    xs = _bf16(X[None, :, None, :] * S[..., None])       # (R, n, P, d)
    full = np.einsum("ni,rnpj->rpij", _bf16(X).astype(np.float64),
                     xs.astype(np.float64))
    want = np.triu(full) + np.swapaxes(np.triu(full, 1), -1, -2)
    got = scaled_grams(torch.from_numpy(X), torch.from_numpy(S),
                       op_dtype="bfloat16").numpy()
    assert_close_to_scale(got, want)
    f32 = scaled_grams(torch.from_numpy(X), torch.from_numpy(S)).numpy()
    assert np.abs(got - f32).max() > 1e-4  # the rounding is really applied


@pytest.mark.parametrize("op_dtype", ["float32", "bfloat16"])
def test_output_is_symmetric(op_dtype):
    X, S = _inputs(R=2)
    out = scaled_grams(torch.from_numpy(X), torch.from_numpy(S),
                       op_dtype=op_dtype)
    assert torch.equal(out, out.transpose(-1, -2))


def test_zero_scale_rows_are_inert():
    X, S = _inputs()
    S_pad = np.concatenate([S, np.zeros((50, 6), np.float32)])
    X_pad = np.concatenate([X, np.full((50, 9), 7.0, np.float32)])
    assert_close_to_scale(
        scaled_grams(torch.from_numpy(X_pad), torch.from_numpy(S_pad)),
        scaled_grams(torch.from_numpy(X), torch.from_numpy(S)),
    )


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "rows", "replicas",
                                 "op_dtype", "rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    X, S = (torch.from_numpy(a) for a in _inputs(R=2))
    kw = {}
    if bad == "dtype":
        X = X.double()
    elif bad == "contiguous":
        S = S.transpose(0, 1)
    elif bad == "rows":
        X = X[:-1]
    elif bad == "replicas":
        X = torch.stack([X, X, X])
    elif bad == "op_dtype":
        kw["op_dtype"] = "float16"
    elif bad == "rank":
        S = S[0, :, 0]
    with pytest.raises((TypeError, ValueError)):
        scaled_grams(X, S, **kw)


def test_cpu_tensors_do_not_count_launches():
    before = scaled_grams.launches
    X, S = _inputs()
    scaled_grams(torch.from_numpy(X), torch.from_numpy(S))
    assert scaled_grams.launches == before


def _replay_kernel_writes(d: int, P: int, g: dict) -> np.ndarray:
    """How many (thread, tile) writers each output entry gets, replaying
    the tile decode and mirrored writes of csrc/scaled_gram.cu."""
    nb = g["d_pad"] // 4
    tpp = nb * (nb + 1) // 2
    writes = np.zeros((P, d, d), np.int64)
    for group in range(g["groups"]):
        p0 = group * g["pg"]
        n_tiles = min(g["pg"], P - p0) * tpp
        for tile in range(n_tiles):  # thread t holds tiles t + k*threads
            tp, rem = divmod(tile, tpp)
            bi = 0
            while rem >= nb - bi:
                rem -= nb - bi
                bi += 1
            bj = bi + rem
            for ii in range(4):
                for jj in range(4):
                    i, j = 4 * bi + ii, 4 * bj + jj
                    if i >= d or j >= d or (bi == bj and ii > jj):
                        continue
                    for (a, b) in {(i, j), (j, i)}:
                        writes[p0 + tp, a, b] += 1
    return writes


@pytest.mark.parametrize("d,P", [(55, 28), (9, 6), (1, 1), (13, 3), (100, 10),
                                 (176, 2)])
def test_kernel_geometry_writes_every_entry_once(d, P):
    n, R = 581_012, 4
    g = kernel_geometry(n, d, P, R, n_sm=132)
    nb = g["d_pad"] // 4
    assert g["pg"] * nb * (nb + 1) // 2 <= gram._TILES_PER_THREAD * g["threads"]
    assert g["threads"] <= gram._MAX_THREADS and g["threads"] % 32 == 0
    assert 4 * g["row_tile"] * (g["pg"] + 1) * g["d_pad"] <= gram._SMEM_BYTES
    assert g["groups"] * g["pg"] >= P > (g["groups"] - 1) * g["pg"]
    assert g["rows_per_split"] % g["row_tile"] == 0
    assert g["splits"] * g["rows_per_split"] >= n
    assert (g["splits"] - 1) * g["rows_per_split"] < n
    assert (_replay_kernel_writes(d, P, g) == 1).all()


def test_kernel_geometry_rejects_too_wide_d():
    with pytest.raises(ValueError, match="register tiling"):
        kernel_geometry(100, 200, 1, 1, n_sm=132)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from spark_bagging_tpu_torch.utils import native

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native.build()
    assert native.library_path().endswith(".so")


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n", [5_000, 2 ** 20 - 1])
def test_exact_probe_sums_are_exact_in_fp32(n):
    # chip_smoke.py holds the kernel to its plain version bit for bit on
    # these inputs; that needs every fp32 sum of them to be exact, up to
    # the largest n the probe accepts
    Xp, Sp = _chip_smoke().probe_inputs(n, 3, 4, 1, device="cpu")
    X64, S64 = Xp.double(), Sp[0].double()
    exact = torch.einsum("ni,np,nj->pij", X64, S64, X64)
    assert torch.equal(scaled_grams(Xp, Sp[0]).double(), exact)
    xs = _bf16(np.asarray(Xp[:, None, :] * Sp[0][:, :, None]))
    exact_bf16 = torch.einsum("ni,npj->pij", X64, torch.from_numpy(xs).double())
    exact_bf16 = exact_bf16.triu() + exact_bf16.triu(1).transpose(-1, -2)
    bf16 = scaled_grams(Xp, Sp[0], op_dtype="bfloat16").double()
    assert torch.equal(bf16, exact_bf16)
    # bf16 rounds the sparse (odd) pair columns only
    assert torch.equal(bf16[0::2], exact[0::2])
    assert not torch.equal(bf16[1::2], exact[1::2])


def test_probe_refuses_inexact_depth():
    with pytest.raises(ValueError, match="exact"):
        _chip_smoke().probe_inputs(2 ** 20, 3, 4, 1, device="cpu")


def test_kernel_tiling_is_stated_once():
    # ops/gram.py owns the tiling; the kernel source takes it from the
    # nvcc defines and refuses to build without them
    from spark_bagging_tpu_torch.utils import native

    src = open(os.path.join(native.CSRC_DIR, "scaled_gram.cu")).read()
    for name, value in gram.CUDA_DEFINES.items():
        assert f"-D{name}={value}" in native._flags()
        assert f"#if !defined({name})" in src or f"!defined({name})" in src
        assert f"= {name};" in src
    assert "#error" in src


@pytest.mark.parametrize("R", [1, 4, 128])
def test_kernel_geometry_bounds_accumulation_depth(R):
    n, d, P = 581_012, 55, 28
    g = kernel_geometry(n, d, P, R, n_sm=132)
    assert g["rows_per_split"] <= gram.MAX_SPLIT_ROWS
    assert g["splits"] * g["rows_per_split"] >= n
    if R >= 4:  # many replicas: the partials stay within launch_bytes
        assert (g["splits"] + 1) * 4.0 * P * d * d <= gram.launch_bytes(n, d, P)
