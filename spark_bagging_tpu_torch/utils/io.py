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
``SyntheticChunks`` and ``as_chunk_source``, without the telemetry
counters. The file readers (``LibsvmChunks``, ``CSVChunks``, Arrow,
hashing) are not ported yet (ROADMAP Queue A 11).
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np

Chunk = tuple[np.ndarray, np.ndarray, int]


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
