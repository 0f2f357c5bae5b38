"""Chunked host-side data sources for out-of-core training.

A copy of the JAX package's ``utils/io.py`` (host-only numpy, no
framework code): a *chunk source* yields fixed-shape host blocks that
the streaming engines ship to the device one at a time. No shuffle is
needed: bagging's resampling is per-row Poisson weights drawn on the
device from the chunk's id, so a chunk can be revisited in any order on
any epoch and regenerate exactly its weights.

Every source yields ``(X, y, n_valid)`` with **constant shapes**
``(chunk_rows, n_features)`` / ``(chunk_rows,)``: the final partial
chunk is zero-padded and ``n_valid`` marks the real rows.

Copied: ``ChunkSource``, ``DropColumnChunks``, ``ArrayChunks``,
``SyntheticChunks``, the file readers ``LibsvmChunks`` and
``CSVChunks`` (the g++-built host loader, ``utils/host_native.py``,
where it builds; the pure-Python parsers, which give the same chunks,
where it does not), ``as_chunk_source`` and the optional zstd codec
resolution, with the ``sbt_chunks_yielded_total`` counter (label
``source``: the source's class name). The Arrow reader is
``utils/arrow.py``, the hashed CSV reader ``utils/hashing.py``.
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np

Chunk = tuple[np.ndarray, np.ndarray, int]

# -- optional compression codec ---------------------------------------
#
# zstandard is a soft dependency everywhere in this package: payload
# compression must degrade, never gate. A consumer of `optional_zstd()`
# falls back to the stdlib `zlib` codec when it returns None, with the
# one-time warning of `warn_zstd_fallback`, so the degradation is
# visible without being fatal.

_WARNED_NO_ZSTD = False


def optional_zstd():
    """The ``zstandard`` module, or None when not installed."""
    try:
        import zstandard

        return zstandard
    except ImportError:
        return None


def warn_zstd_fallback(context: str) -> None:
    """One-time (per process) notice that zstd was requested but the
    stdlib codec is being used instead."""
    global _WARNED_NO_ZSTD
    if _WARNED_NO_ZSTD:
        return
    _WARNED_NO_ZSTD = True
    import warnings

    warnings.warn(
        f"zstandard is not installed; {context} falls back to the "
        "stdlib zlib codec (slower, larger payloads). `pip install "
        "zstandard` to restore zstd compression.",
        stacklevel=3,
    )


def _pad_chunk(
    X: np.ndarray, y: np.ndarray, chunk_rows: int
) -> Chunk:
    n = X.shape[0]
    if n == chunk_rows:
        return X, y, n
    Xp = np.zeros((chunk_rows, X.shape[1]), X.dtype)
    yp = np.zeros((chunk_rows,), y.dtype)
    Xp[:n], yp[:n] = X, y
    return Xp, yp, n


class ChunkSource:
    """Base chunk source: fixed-shape ``(X, y, n_valid)`` blocks.

    Subclasses set ``n_features``/``n_rows``/``chunk_rows`` and implement
    ``_iter_raw()`` yielding variable-length host blocks **in a
    deterministic order** (chunk ids index that order; determinism is
    what makes re-epoch weight regeneration exact).
    """

    n_features: int
    n_rows: int
    chunk_rows: int

    def _iter_raw(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        raise NotImplementedError

    @property
    def n_chunks(self) -> int:
        return -(-self.n_rows // self.chunk_rows)

    def chunks(self) -> Iterator[Chunk]:
        """Yield fixed-shape padded chunks for one epoch."""
        return self._chunks_over(self._iter_raw())

    def chunks_from(self, start: int) -> Iterator[Chunk]:
        """Yield padded chunks beginning at chunk index ``start`` — the
        checkpoint-resume fast path. Sources with random access define
        ``_iter_raw_from(start_chunk)`` (raw blocks from that chunk
        boundary on) and seek in O(1); everything else falls back to
        consuming and discarding the first ``start`` chunks, which is
        correct but pays the skipped ingestion."""
        if start <= 0:
            yield from self.chunks()
            return
        raw_from = getattr(self, "_iter_raw_from", None)
        if raw_from is not None:
            yield from self._chunks_over(raw_from(start))
            return
        it = self.chunks()
        for i, item in enumerate(it):
            if i >= start:
                yield item

    def _chunks_over(self, raw) -> Iterator[Chunk]:
        from spark_bagging_tpu_torch import telemetry

        src = type(self).__name__
        buf_X: list[np.ndarray] = []
        buf_y: list[np.ndarray] = []
        buffered = 0
        for X, y in raw:
            X = np.ascontiguousarray(X, np.float32)
            y = np.asarray(y)
            buf_X.append(X)
            buf_y.append(y)
            buffered += len(y)
            while buffered >= self.chunk_rows:
                Xa = np.concatenate(buf_X) if len(buf_X) > 1 else buf_X[0]
                ya = np.concatenate(buf_y) if len(buf_y) > 1 else buf_y[0]
                telemetry.inc("sbt_chunks_yielded_total",
                              labels={"source": src})
                yield Xa[: self.chunk_rows], ya[: self.chunk_rows], self.chunk_rows
                buffered -= self.chunk_rows
                # drop zero-length leftovers: a lingering empty view
                # forces a full-chunk concatenate copy on every
                # subsequent exact-boundary block
                if buffered == 0:
                    buf_X, buf_y = [], []
                else:
                    buf_X = [Xa[self.chunk_rows:]]
                    buf_y = [ya[self.chunk_rows:]]
        if buffered > 0:
            Xa = np.concatenate(buf_X) if len(buf_X) > 1 else buf_X[0]
            ya = np.concatenate(buf_y) if len(buf_y) > 1 else buf_y[0]
            # the padded tail is a yielded chunk too: producer/consumer
            # counter diffs must not show a phantom gap of one a pass
            telemetry.inc("sbt_chunks_yielded_total",
                          labels={"source": src})
            yield _pad_chunk(Xa, ya, self.chunk_rows)


class DropColumnChunks(ChunkSource):
    """View of another source with one column removed.

    Lets a stream-fitted aux-channel model (AFT's censor column) run
    its predict/score passes on the SAME wide source it was trained
    on: the fit consumes the ``aux_col`` column, so scoring must drop
    the identical column or the width check rejects the model's own
    training source. The index is taken modulo the full source width,
    as the fit takes it.
    """

    def __init__(self, inner: ChunkSource, col: int):
        self.inner = inner
        self.col = col % inner.n_features
        self.n_features = inner.n_features - 1
        self.n_rows = inner.n_rows
        self.chunk_rows = inner.chunk_rows

    def _iter_raw(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        for X, y in self.inner._iter_raw():
            yield np.delete(np.asarray(X, np.float32), self.col, axis=1), y

    def chunks_from(self, start: int) -> Iterator[Chunk]:
        # delegate the seek to the inner source (which may be O(1))
        for X, y, n in self.inner.chunks_from(start):
            yield np.delete(np.asarray(X, np.float32), self.col, axis=1), y, n


class ArrayChunks(ChunkSource):
    """Chunk view over in-memory arrays (or np.memmap for on-disk)."""

    def __init__(self, X: np.ndarray, y: np.ndarray, chunk_rows: int):
        if X.shape[0] != y.shape[0]:
            raise ValueError("X and y row counts differ")
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
        self._X, self._y = X, y
        self.n_rows = int(X.shape[0])
        self.n_features = int(X.shape[1])
        self.chunk_rows = int(chunk_rows)

    def _iter_raw(self):
        yield from self._iter_raw_from(0)

    def _iter_raw_from(self, start_chunk: int):
        for start in range(
            start_chunk * self.chunk_rows, self.n_rows, self.chunk_rows
        ):
            yield (
                self._X[start : start + self.chunk_rows],
                self._y[start : start + self.chunk_rows],
            )


class SyntheticChunks(ChunkSource):
    """Out-of-core synthetic data: each chunk is generated on demand from
    ``make_fn(n_rows, seed=chunk_seed)`` — nothing larger than one chunk
    ever exists on the host (BASELINE config 4's 11M HIGGS rows).

    The per-chunk seed varies the *rows*; the dataset's structure
    (mixture centers / true coefficients) must be chunk-invariant or the
    stream is a nonstationary mixture, not one dataset. When ``make_fn``
    accepts a ``structure_seed`` kwarg (the ``utils.datasets``
    generators do), it is pinned to the source's ``seed`` automatically;
    otherwise ``make_fn`` itself must guarantee chunk-invariance.

    Chunk seeds are ``SeedSequence``-mixed from ``(seed, chunk_id)``,
    not additive: with ``seed + 1 + c`` two sources at nearby base
    seeds (train seed=0, eval seed=5) would generate row-identical
    chunks offset by 5 — silently leaking train rows into held-out
    data at any realistic chunk count.
    """

    def __init__(
        self,
        make_fn: Callable[..., tuple[np.ndarray, np.ndarray]],
        n_rows: int,
        chunk_rows: int,
        *,
        seed: int = 0,
    ):
        import inspect

        self._seed = seed
        try:
            accepts_structure = "structure_seed" in inspect.signature(
                make_fn
            ).parameters
        except (TypeError, ValueError):  # builtins/partials w/o signature
            accepts_structure = False
        if accepts_structure:
            self._make_fn = lambda n, seed: make_fn(
                n, seed=seed, structure_seed=self._seed
            )
        else:
            self._make_fn = make_fn
        self.n_rows = int(n_rows)
        self.chunk_rows = int(chunk_rows)
        X0, _ = self._make_fn(1, seed=seed)
        self.n_features = int(X0.shape[1])

    def _chunk_seed(self, c: int) -> int:
        # chunk-id-keyed and hash-mixed: epoch-stable, order-
        # independent, and collision-free across nearby base seeds
        return int(
            np.random.SeedSequence((self._seed, c)).generate_state(1)[0]
        )

    def _iter_raw(self):
        yield from self._iter_raw_from(0)

    def _iter_raw_from(self, start_chunk: int):
        for c in range(start_chunk, self.n_chunks):
            n = min(self.chunk_rows, self.n_rows - c * self.chunk_rows)
            yield self._make_fn(n, seed=self._chunk_seed(c))


class LibsvmChunks(ChunkSource):
    """Stream a libsvm file in chunks without loading it whole.

    ``n_features`` must be given (a streaming reader can't know the
    global max index up front); rows are densified per chunk.
    """

    def __init__(
        self,
        path: str,
        n_features: int,
        chunk_rows: int,
        *,
        zero_based: bool = False,
        n_rows: int | None = None,
    ):
        self.path = path
        self.n_features = int(n_features)
        self.chunk_rows = int(chunk_rows)
        self._zero_based = zero_based
        if n_rows is None:
            n_rows = self._count_rows()
        self.n_rows = int(n_rows)

    def _count_rows(self) -> int:
        from spark_bagging_tpu_torch.utils.host_native import get_lib

        lib = get_lib()
        if lib is not None:  # native scan: the file may be huge
            import ctypes

            rows, maxf = ctypes.c_int64(), ctypes.c_int64()
            rc = lib.svm_dims(
                self.path.encode(), int(self._zero_based),
                ctypes.byref(rows), ctypes.byref(maxf),
            )
            if rc == 0:
                return int(rows.value)
        with open(self.path) as f:
            return sum(
                1 for line in f if line.split("#", 1)[0].strip()
            )

    def _iter_raw(self):
        from spark_bagging_tpu_torch.utils.host_native import (
            NativeReader,
            note_served,
        )

        reader = NativeReader.open_svm(
            self.path, self.n_features, self.chunk_rows,
            zero_based=self._zero_based,
        )
        if reader is not None:  # native C++ streaming parser
            note_served("native")
            yield from reader
            return
        note_served("python")
        X = np.zeros((self.chunk_rows, self.n_features), np.float32)
        y = np.zeros((self.chunk_rows,), np.float32)
        i = 0
        with open(self.path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                parts = line.split()
                y[i] = float(parts[0])
                for item in parts[1:]:
                    idx_s, val_s = item.split(":")
                    j = int(idx_s) - (0 if self._zero_based else 1)
                    if 0 <= j < self.n_features:
                        X[i, j] = float(val_s)
                i += 1
                if i == self.chunk_rows:
                    yield X.copy(), y.copy()
                    X[:] = 0.0
                    i = 0
        if i > 0:
            yield X[:i].copy(), y[:i].copy()


class CSVChunks(ChunkSource):
    """Stream a numeric CSV in chunks (label in ``label_col``)."""

    def __init__(
        self,
        path: str,
        chunk_rows: int,
        *,
        label_col: int = -1,
        skip_header: bool = False,
        n_rows: int | None = None,
    ):
        self.path = path
        self.chunk_rows = int(chunk_rows)
        self._label_col = label_col
        self._skip_header = skip_header
        counted_rows = 0
        if n_rows is not None:
            # the counting pass exists only to learn n_rows; with it
            # supplied, only the first non-blank line is needed for
            # n_cols: a Criteo-scale file must not be read twice
            n_cols = 0
            with open(path) as f:
                for line in f:
                    if line.strip():
                        n_cols = len(line.split(","))
                        break
        else:
            dims = self._native_dims()
            if dims is not None:
                counted_rows, n_cols = dims
            else:
                # mirror the native csv_dims exactly: blank lines never
                # count, and n_cols comes from the first NON-blank line
                n_cols = counted_rows = 0
                with open(path) as f:
                    for line in f:
                        if not line.strip():
                            continue
                        if n_cols == 0:
                            n_cols = len(line.split(","))
                        counted_rows += 1
                if skip_header and counted_rows > 0:
                    counted_rows -= 1
        lc = label_col + n_cols if label_col < 0 else label_col
        if n_cols < 2 or lc < 0 or lc >= n_cols:
            raise ValueError(
                f"label_col {label_col} out of range for {n_cols} columns"
            )
        self.n_features = n_cols - 1
        self.n_rows = int(n_rows if n_rows is not None else counted_rows)

    def _native_dims(self) -> tuple[int, int] | None:
        from spark_bagging_tpu_torch.utils.host_native import get_lib

        lib = get_lib()
        if lib is None:
            return None
        import ctypes

        rows, cols = ctypes.c_int64(), ctypes.c_int64()
        rc = lib.csv_dims(
            self.path.encode(), int(self._skip_header),
            ctypes.byref(rows), ctypes.byref(cols),
        )
        if rc != 0:
            return None
        return int(rows.value), int(cols.value)

    def _iter_raw(self):
        from spark_bagging_tpu_torch.utils.host_native import (
            NativeReader,
            note_served,
        )

        reader = NativeReader.open_csv(
            self.path, self.n_features + 1, self.chunk_rows,
            label_col=self._label_col, skip_header=self._skip_header,
        )
        if reader is not None:  # native C++ streaming parser
            note_served("native")
            yield from reader
            return
        note_served("python")
        # parse into a preallocated f32 buffer row by row (as the
        # libsvm fallback does): a list-of-lists of boxed floats costs
        # ~8x the chunk's array size transiently
        n_cols = self.n_features + 1
        buf = np.empty((self.chunk_rows, n_cols), np.float32)
        filled = 0
        with open(self.path) as f:
            if self._skip_header:
                # discard the first non-blank line (the header), as the
                # native reader and csv_dims do
                for line in f:
                    if line.strip():
                        break
            for line in f:
                line = line.strip()
                if not line:
                    continue
                buf[filled] = line.split(",")
                filled += 1
                if filled == self.chunk_rows:
                    yield self._to_xy(buf, filled)
                    filled = 0
        if filled:
            yield self._to_xy(buf, filled)

    def _to_xy(self, buf: np.ndarray, n: int):
        data = buf[:n]
        y = data[:, self._label_col].copy()
        X = np.delete(data, self._label_col % data.shape[1], axis=1)
        return np.ascontiguousarray(X), y


def as_chunk_source(data, chunk_rows: int | None = None) -> ChunkSource:
    """Coerce ``(X, y)`` tuples or an existing source to a ChunkSource."""
    if isinstance(data, ChunkSource):
        return data
    if isinstance(data, tuple) and len(data) == 2:
        X, y = np.asarray(data[0]), np.asarray(data[1])
        if chunk_rows is None:
            chunk_rows = min(int(X.shape[0]), 65536)
        return ArrayChunks(X, y, chunk_rows)
    raise TypeError(
        f"expected a ChunkSource or an (X, y) tuple, got {type(data).__name__}"
    )
