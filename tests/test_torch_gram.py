"""The port's scaled-Gram op (spark_bagging_tpu_torch/ops/gram.py).

On the CPU the wrapper computes the plain torch version, held here
against the JAX package's Pallas kernel in interpret mode. The CUDA
kernel runs only on the card (tests/test_torch_cuda.py and
chip_smoke.py); its launch geometry is arithmetic and is checked here
by replaying the kernel's tile decode, the float32 design's bands read
from the kernel source (the wrapper asks the built library for their
count, which these tests stand in for).
"""

import functools
import os
import re

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


def _replay_sync_writes(d: int, P: int, R: int, g: dict,
                        shared_x: bool) -> np.ndarray:
    """How many (block, warp, accumulator) writers each output entry of
    one row split gets, replaying csrc/scaled_gram.cu's bfloat16 design
    (mma.sync): the block's (replica, pair) decode, the output-tile
    items (diagonal tiles, then two 32-row halves of each tile above
    them), the kept 16x8 accumulator tiles, and the mirrored writes.
    Only tiles the kernel computes (inside d) may write."""
    writes = np.zeros((R, P, d, d), np.int64)
    Q = R * P if shared_x else P
    nt = -(-d // 64)
    assert g["items"] == nt * nt
    for gx in range(g["n_x"] * g["groups"]):
        xi, grp = divmod(gx, g["groups"])
        qb = grp * g["pg"]
        nq = min(g["pg"], Q - qb)
        assert nq >= 1
        for item in range(nt * nt):
            if item < nt:
                diag, MI, row0 = True, 4, 64 * item
                col0 = row0
            else:
                diag, MI = False, 2
                u, h = divmod(item - nt, 2)
                I = 0
                while u >= nt - 1 - I:
                    u -= nt - 1 - I
                    I += 1
                row0, col0 = 64 * I + 32 * h, 64 * (I + 1 + u)
            mi_n = min(MI, -(-(d - row0) // 16))
            nj_n = min(8, -(-(d - col0) // 8))
            for mi in range(MI):
                for nj in range(8):
                    if diag and nj < 2 * mi:
                        continue
                    il = 16 * mi + np.arange(16)[:, None]
                    jl = 8 * nj + np.arange(8)[None, :]
                    keep = (row0 + il < d) & (col0 + jl < d)
                    if diag:
                        keep &= il <= jl
                    if not keep.any():
                        continue
                    assert mi < mi_n and nj < nj_n  # written means computed
                    i = (row0 + il + 0 * jl)[keep]
                    j = (col0 + jl + 0 * il)[keep]
                    for w in range(nq):
                        r, p = divmod(xi * Q + qb + w, P)
                        np.add.at(writes[r, p], (i, j), 1)
                        off = i != j
                        np.add.at(writes[r, p], (j[off], i[off]), 1)
    return writes


@functools.cache
def _kernel_shapes() -> list:
    """The float32 design's item shapes as csrc/scaled_gram.cu's list
    states them: ``X(index, W0, W1, W2, W3, off)`` in
    ``SBT_GRAM_SHAPES``, as (the bands' widths in 8-column groups, off
    the diagonal)."""
    from spark_bagging_tpu_torch.utils import native

    src = open(os.path.join(native.CSRC_DIR, "scaled_gram.cu")).read()
    table = src[src.index("#define SBT_GRAM_SHAPES(X)"):]
    table = table[:table.index("\n\n")]
    found = re.findall(r"X\((\d+), (\d), (\d), (\d), (\d), "
                       r"(true|false)\)", table)
    assert [int(f[0]) for f in found] == list(range(len(found)))
    return [(tuple(int(w) for w in f[1:5] if w != "0"), f[5] == "true")
            for f in found]


def _wgmma_decode(y: int, g8: int) -> tuple[int, int, int]:
    """csrc/scaled_gram.cu ``decode_item``: (shape, jb0, ja0) of item y
    over g8 8-feature groups."""
    nt = -(-g8 // 8)
    wl = g8 - 8 * (nt - 1)
    n_diag = 2 * (nt - 1) + (2 if wl == 8 else 1)
    if y < n_diag:
        T = min(y >> 1, nt - 1)
        if T < nt - 1 or wl == 8:
            h = y - 2 * T
            return 7 + h, 8 * T + 2 * h, 8 * T + 2 * h
        return wl - 1, 8 * T, 8 * T
    u, h = divmod(y - n_diag, 2)
    I = 0
    while u >= nt - 1 - I:
        u -= nt - 1 - I
        I += 1
    J = I + 1 + u
    return 8 + min(8, g8 - 8 * J), 8 * J, 8 * I + 4 * h


def _wgmma_items(d: int) -> list[tuple[int, int, int]]:
    """The float32 design's items along d, enumerated: ``(shape, jb0,
    ja0)``. Along d lie ``ceil(d / 64)`` tiles of 64, the last ``wl``
    groups wide: a full diagonal tile is two items (bands {0, 3} and
    {1, 2}: shapes 7 and 8), a narrower last one is one item of all its
    bands (shape wl - 1); each tile (I, J) above the diagonal is two
    items of two row bands each (shape 8 + tile J's width)."""
    g8 = -(-d // 8)
    nt = -(-g8 // 8)
    items = []
    for T in range(nt):
        if g8 - 8 * T >= 8:
            items += [(7, 8 * T, 8 * T), (8, 8 * T + 2, 8 * T + 2)]
        else:
            items.append((g8 - 8 * T - 1, 8 * T, 8 * T))
    for I in range(nt):
        for J in range(I + 1, nt):
            w = min(8, g8 - 8 * J)
            items += [(8 + w, 8 * J, 8 * I + 4 * h) for h in (0, 1)]
    return items


def _wgmma_layout(d: int) -> tuple[int, int]:
    """What the library's ``sbt_gram_items`` counts: the items and the
    8-column groups their bands multiply."""
    items = _wgmma_items(d)
    shapes = _kernel_shapes()
    return len(items), sum(sum(shapes[s][0]) for s, _, _ in items)


@pytest.fixture
def replayed_layout(monkeypatch):
    """The float32 design's band count from the kernel source, in the
    place of the built library's (no compiler here)."""
    monkeypatch.setattr(gram, "wgmma_layout", _wgmma_layout)


def _replay_wgmma_writes(d: int, P: int, R: int, g: dict,
                         shared_x: bool) -> np.ndarray:
    """The same count for the float32 design (wgmma), replaying its
    item decode, each item's bands (a diagonal item's band k starts
    W0 - Wk groups into its windows, rows and columns; an off-diagonal
    item's two row bands are groups 0-1 and 2-3 of its A window against
    all of its columns), each warp's 16 rows by 8 W columns of a band,
    and the mirrored writes of the entries i <= j inside d. Every band
    reads its rows and columns inside its windows."""
    shapes = _kernel_shapes()
    writes = np.zeros((R, P, d, d), np.int64)
    Q = R * P if shared_x else P
    g8 = -(-d // 8)
    for gx in range(g["n_x"] * g["groups"]):
        xi, grp = divmod(gx, g["groups"])
        qb = grp * g["pg"]
        nq = min(g["pg"], Q - qb)
        assert nq >= 1
        for y in range(g["items"]):
            shape, jb0, ja0 = _wgmma_decode(y, g8)
            widths, off = shapes[shape]
            W0 = widths[0]
            assert jb0 + W0 <= g8  # the raw window is inside X's groups
            for k, w in enumerate(widths):
                a_off = 2 * k if off else W0 - w
                b_off = 0 if off else W0 - w
                upper = off or a_off + 1 < W0
                assert b_off + w <= W0
                assert a_off + 1 + upper <= (4 if off else W0)
                i0 = 8 * ((ja0 if off else jb0) + a_off)
                j0 = 8 * (jb0 + b_off)
                i = i0 + np.arange(16)[:, None]
                j = j0 + np.arange(8 * w)[None, :]
                keep = (i < d) & (j < d) & ((j >= i) | off)
                if not upper:  # rows past the window lie past d
                    assert not (i[8:] < d).any()
                ii = (i + 0 * j)[keep]
                jj = (j + 0 * i)[keep]
                for wp in range(nq):
                    r, p = divmod(xi * Q + qb + wp, P)
                    np.add.at(writes[r, p], (ii, jj), 1)
                    diag = ii != jj
                    np.add.at(writes[r, p], (jj[diag], ii[diag]), 1)
    return writes


@pytest.mark.parametrize("op_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared_x", [True, False])
@pytest.mark.parametrize("d,P", [(55, 28), (9, 6), (1, 1), (13, 3), (100, 10),
                                 (176, 2), (250, 28), (913, 3)])
def test_kernel_geometry_writes_every_entry_once(d, P, shared_x, op_dtype,
                                                 replayed_layout):
    n, R = 581_012, 3
    g = kernel_geometry(n, d, P, R, n_sm=132, shared_x=shared_x,
                        op_dtype=op_dtype)
    assert g["pg"] <= gram._PAIRS[op_dtype]
    Q = R * P if shared_x else P
    assert g["groups"] * g["pg"] >= Q > (g["groups"] - 1) * g["pg"]
    assert g["n_x"] == (1 if shared_x else R)
    assert g["rows_per_split"] % gram._ROW_TILE == 0
    assert g["rows_per_split"] <= gram.MAX_SPLIT_ROWS
    assert g["splits"] * g["rows_per_split"] >= n
    assert (g["splits"] - 1) * g["rows_per_split"] < n
    replay = (_replay_wgmma_writes if op_dtype == "float32"
              else _replay_sync_writes)
    assert (replay(d, P, R, g, shared_x) == 1).all()


@pytest.mark.parametrize("d,P", [(250, 28), (913, 3), (4096, 1)])
def test_kernel_geometry_takes_the_reference_widths(d, P, replayed_layout):
    # the JAX kernel's VMEM envelope reaches d = 250 at P = 28 and
    # d = 913 at P = 3; the items take any d within CUDA's grid extents,
    # and their enumeration is the kernel's decode
    g = kernel_geometry(581_012, d, P, 121, n_sm=132)
    items = _wgmma_items(d)
    assert g["items"] == len(items) <= 65535
    assert items == [_wgmma_decode(y, -(-d // 8)) for y in range(len(items))]
    nt = -(-d // 64)
    assert kernel_geometry(581_012, d, P, 121, n_sm=132,
                           op_dtype="bfloat16")["items"] == nt * nt


def test_kernel_geometry_refuses_beyond_the_grid(replayed_layout):
    with pytest.raises(ValueError, match="grid"):
        kernel_geometry(100, 64 * 256, 1, 1, n_sm=132)


def test_wgmma_shapes_are_the_kernel_switch():
    # the kernel's one list of item shapes feeds its switch, its windows
    # and its band count; every shape the decode gives at any width is
    # in it, and a diagonal item's bands narrow by two groups a band
    from spark_bagging_tpu_torch.utils import native

    src = open(os.path.join(native.CSRC_DIR, "scaled_gram.cu")).read()
    for use in ("SBT_GRAM_SHAPES(SBT_GRAM_CASE)", "SBT_GRAM_SHAPES(SBT_GRAM_W0)",
                "SBT_GRAM_SHAPES(SBT_GRAM_BANDS)"):
        assert src.count(use) == 1, use
    shapes = _kernel_shapes()
    used = {s for d in range(1, 200) for s, _, _ in _wgmma_items(d)}
    assert used == set(range(len(shapes))) and len(shapes) == 17
    for widths, off in shapes:
        assert all(w <= 8 for w in widths) and len(widths) <= 4
        if off:
            assert len(widths) == 2 and widths[0] == widths[1]
        else:
            assert all((widths[0] - w) % 2 == 0 for w in widths)
            assert list(widths) == sorted(set(widths), reverse=True)


@pytest.mark.parametrize("d,least", [(55, 0.70), (250, 0.85), (4096, 0.99)])
def test_issued_share_of_the_upper_triangle(d, least, replayed_layout):
    # the bands multiply only the columns from their first row on: at
    # the headline's d = 55, N = 56, 40, 24 and 8 (2048 products a row
    # for the triangle's 1540 entries)
    g = kernel_geometry(581_012, d, 28, 121, n_sm=132)
    assert least <= g["issued_share"] <= 1.0
    if d == 55:
        assert g["issued_share"] == 1540 / 2048


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from spark_bagging_tpu_torch.ops import kernels
    from spark_bagging_tpu_torch.utils import native

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native.build(kernels.defines())
    assert native.library_path(kernels.defines()).endswith(".so")


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
    from spark_bagging_tpu_torch.ops import kernels
    from spark_bagging_tpu_torch.utils import native

    src = open(os.path.join(native.CSRC_DIR, "scaled_gram.cu")).read()
    for name, value in gram.CUDA_DEFINES.items():
        assert f"-D{name}={value}" in native._flags(kernels.defines())
        assert f"#if !defined({name})" in src or f"!defined({name})" in src
        assert f"= {name};" in src
    assert "#error" in src


@pytest.mark.parametrize("R", [1, 4, 128])
def test_kernel_geometry_bounds_accumulation_depth(R, replayed_layout):
    n, d, P = 581_012, 55, 28
    g = kernel_geometry(n, d, P, R, n_sm=132)
    assert g["rows_per_split"] <= gram.MAX_SPLIT_ROWS
    assert g["splits"] * g["rows_per_split"] >= n
    if R >= 4:  # many replicas: the partials stay within launch_bytes
        assert (g["splits"] + 1) * 4.0 * P * d * d <= gram.launch_bytes(n, d, P)


def test_scratch_bytes_price_the_launch_images():
    # the float32 design's per-launch scratch (X and its TF32 remainder
    # in wgmma's layout) is what the memory model charges: once for a
    # shared X, once a replica for a gathered subspace; the headline's
    # chunk of the card's budget stays at 9 chunks or fewer
    from spark_bagging_tpu_torch import LogisticRegression
    from spark_bagging_tpu_torch.utils.memory import SAFETY, auto_chunk_size

    n, F, C = 581_012, 54, 7
    want = 4.0 * 2 * (-(-n // 64) * 64) * (-(-(F + 1) // 8) * 8)
    assert gram.scratch_bytes(n, F + 1) == want == 4.0 * np.prod(
        gram.image_shape(n, F + 1))
    assert gram.scratch_bytes(n, F + 1, "bfloat16") == 0.0
    kernel = LogisticRegression(max_iter=1, hessian_impl="pallas")
    assert kernel.prepared_bytes(n, F) == want
    assert kernel.subspace_gather_bytes(n, 40) == (
        4.0 * n * 40 + gram.scratch_bytes(n, 41))
    for other in (LogisticRegression(hessian_impl="blocked"),
                  LogisticRegression(hessian_impl="pallas", precision="high"),
                  LogisticRegression(hessian_impl="pallas", solver="adam")):
        assert other.prepared_bytes(n, F) == 0.0
    budget = SAFETY * 79.1e9  # an H100's free memory before the fit
    chunk = auto_chunk_size(kernel, n, F, C, 1000, torch.device("cpu"),
                            budget_bytes=budget, n_features=F)
    assert 112 <= chunk <= 125  # 9 chunks of 1000 replicas
