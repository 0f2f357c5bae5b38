"""The port's in-process mesh (``spark_bagging_tpu_torch/parallel``)
against the JAX package's ``parallel``.

``make_mesh`` takes JAX's shapes and raises JAX's errors; ``pad_rows``
and ``pad_rows_X`` are bitwise JAX's; the ``shard_map`` runner gives its
bodies JAX's collectives, sums in a fixed shard order (bitwise across
reruns), and a body that raises fails the call without hanging its
siblings. The port's mesh is ``[torch.device("cpu")] * 8``; JAX's is the
8-device CPU mesh of tests/conftest.py.
"""

import threading
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import spark_bagging_tpu.parallel as JP  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu.parallel.sharded import (  # noqa: E402
    pad_rows as jpad_rows,
    pad_rows_X as jpad_rows_X,
)
from spark_bagging_tpu_torch import parallel as TP  # noqa: E402
from spark_bagging_tpu_torch.ops.reduce import maybe_psum  # noqa: E402
from spark_bagging_tpu_torch.parallel import compat  # noqa: E402
from spark_bagging_tpu_torch.parallel.compat import P  # noqa: E402
from spark_bagging_tpu_torch.parallel.sharded import (  # noqa: E402
    pad_rows,
    pad_rows_X,
)

CPU8 = [torch.device("cpu")] * 8


def test_exports_are_the_jax_packages_less_multiprocess():
    """The exports equal JAX's: since the multi-process half of
    ``parallel/`` was ported, ``initialize_distributed`` among them (the
    difference the name recalls is empty)."""
    assert set(JP.__all__) - set(TP.__all__) == set()
    assert TP.__all__ == JP.__all__
    for name in TP.__all__:
        assert hasattr(TP, name), name
    assert TP.HAS_SHARD_MAP is True
    assert T.make_mesh is TP.make_mesh


@pytest.mark.parametrize("data,replica,shape", [
    (1, None, (1, 8)), (8, None, (8, 1)), (2, None, (2, 4)),
    (2, 4, (2, 4)), (4, 2, (4, 2)),
])
def test_make_mesh_shapes_equal_jax(data, replica, shape):
    t = TP.make_mesh(data, replica, devices=CPU8)
    j = JP.make_mesh(data, replica)
    assert t.devices.shape == j.devices.shape == shape
    assert t.shape == dict(j.shape)
    assert t.axis_names == tuple(j.axis_names)


@pytest.mark.parametrize("data,replica", [(3, None), (2, 3), (0, None),
                                          (1, 0), (-1, 8)])
def test_make_mesh_errors_equal_jax(data, replica):
    with pytest.raises(ValueError) as te:
        TP.make_mesh(data, replica, devices=CPU8)
    with pytest.raises(ValueError) as je:
        JP.make_mesh(data, replica)
    assert str(te.value) == str(je.value)


def test_make_mesh_accepts_repeated_devices_and_needs_cuda_by_default():
    """A device may repeat (a deliberate difference from JAX: one card
    drives every sharded path); without ``devices=`` the mesh is over
    the CUDA devices, and raises without one."""
    m = TP.make_mesh(replica=4, devices=["cpu"] * 4)
    assert m.shape == {"data": 1, "replica": 4}
    assert m.first_device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            TP.make_mesh()


@pytest.mark.parametrize("n", [16, 13, 1])
def test_pad_rows_equal_jax(n):
    rng = np.random.default_rng(n)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    y = rng.integers(0, 3, size=n)
    for mine, theirs in zip(pad_rows(X, y, 8), jpad_rows(X, y, 8)):
        assert isinstance(mine, np.ndarray)
        np.testing.assert_array_equal(mine, np.asarray(theirs))
        assert mine.dtype == np.asarray(theirs).dtype
    np.testing.assert_array_equal(pad_rows_X(X, 8),
                                  np.asarray(jpad_rows_X(X, 8)))
    # torch in, torch out
    Xt, yt, mt = pad_rows(torch.as_tensor(X), torch.as_tensor(y), 8)
    np.testing.assert_array_equal(Xt.numpy(), pad_rows(X, y, 8)[0])
    assert mt.dtype == torch.float32 and int(mt.sum()) == n


def test_device_put_rows():
    mesh = TP.make_mesh(2, devices=CPU8)
    X = np.arange(24, dtype=np.float32).reshape(8, 3)
    blocks = TP.device_put_rows(X, mesh)
    assert len(blocks) == 2 and len(blocks[0]) == 4
    np.testing.assert_array_equal(blocks[1][3].numpy(), X[4:])
    with pytest.raises(ValueError, match="pad rows first"):
        TP.device_put_rows(X[:7], mesh)


def test_runner_specs_and_collectives():
    mesh = TP.make_mesh(2, 4, devices=CPU8)
    X = torch.arange(16, dtype=torch.float32).reshape(8, 2)
    ids = torch.arange(8)

    def body(Xs, r, c):
        d = compat.axis_index("data")
        k = compat.axis_index("replica")
        assert Xs.shape == (4, 2) and r.shape == (2,)
        row_sum = compat.psum(Xs.sum(0), "data")
        gathered = compat.all_gather(r, "replica")
        return (r * 10 + d, row_sum, gathered,
                torch.tensor([d * 4 + k]) + c)

    out = compat.shard_map(
        body, mesh=mesh,
        in_specs=(P("data", None), P("replica"), P()),
        out_specs=(P("replica"), P(), P(), P("data")))(
            X, ids, torch.tensor(0))
    np.testing.assert_array_equal(out[0].numpy(), np.arange(8) * 10)
    np.testing.assert_array_equal(out[1].numpy(), X.sum(0).numpy())
    np.testing.assert_array_equal(out[2].numpy(), np.arange(8))
    np.testing.assert_array_equal(out[3].numpy(), [0, 4])


def test_psum_sums_in_shard_order_bitwise_across_reruns():
    """Every member's tensor summed left to right in shard order: a
    rerun is bitwise the same, and equals the sequential sum."""
    mesh = TP.make_mesh(8, devices=CPU8)
    rng = np.random.default_rng(0)
    parts = torch.as_tensor(rng.normal(size=(8, 1000)).astype(np.float32)
                            * np.logspace(-8, 8, 1000, dtype=np.float32))

    def body(p):
        return maybe_psum(p[0], "data")

    run = compat.shard_map(body, mesh=mesh, in_specs=(P("data"),),
                           out_specs=P())
    first = run(parts)
    expect = parts[0].clone()
    for k in range(1, 8):
        expect = expect + parts[k]
    for _ in range(3):
        assert torch.equal(run(parts), first)
    assert torch.equal(first, expect)


def test_a_raising_shard_fails_the_call_without_a_hang():
    mesh = TP.make_mesh(4, devices=CPU8[:4])

    def body(x):
        if compat.axis_index("data") == 2:
            raise KeyError("shard 2 failed")
        # the others wait at a collective shard 2 never reaches
        return maybe_psum(x, "data")

    t0 = time.monotonic()
    with pytest.raises(KeyError, match="shard 2 failed"):
        compat.shard_map(body, mesh=mesh, in_specs=(P("data"),),
                         out_specs=P())(torch.ones(4))
    assert time.monotonic() - t0 < 30
    assert threading.active_count() < 50  # no thread left waiting


def test_collectives_refuse_outside_a_body():
    with pytest.raises(RuntimeError, match="outside a shard_map"):
        maybe_psum(torch.ones(2), "data")
    assert maybe_psum(3.0, None) == 3.0


def test_launch_counts_are_exact_under_threads():
    """The kernel wrappers' counters take one lock: 8 shards counting
    1,000 launches each lose none, and each shard's own count is kept."""
    def fake():
        pass

    fake.launches = 0
    mesh = TP.make_mesh(8, devices=CPU8)

    def body(x):
        for _ in range(1000):
            compat.count_launch(fake)
        return x

    compat.shard_map(body, mesh=mesh, in_specs=(P("data"),),
                     out_specs=P("data"))(torch.zeros(8))
    assert fake.launches == 8000
    assert fake.shard_launches[("launches", (3, 0))] == 1000
