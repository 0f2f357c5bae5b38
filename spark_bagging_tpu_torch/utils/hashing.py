"""Feature hashing (the hashing trick) for categorical ingestion.

A copy of the JAX package's ``utils/hashing.py`` (host numpy). The
Criteo-shaped configuration is the one dataset whose raw form is not
numeric: 13 integer and 26 categorical columns. Signed feature hashing
into a fixed dense width, applied host-side per chunk, lets the device
see only the dense ``(chunk, n_features)`` blocks the streaming engines
already consume.

Design notes:

- **Stable hash**: ``zlib.crc32`` over ``b"<col>=<value>"`` with a
  seed: deterministic across processes and Python runs (unlike
  ``hash()``), C-speed, and the host loader's ``crc32_update``
  (``native/loader.cpp``) computes the same bits, so both paths emit
  the same hashed matrix.
- **Signed**: a second hash gives each token a ±1 sign, making
  collisions cancel in expectation.
- **Vocabulary cache**: per-column value→(index, sign) memo, so hashing
  is amortized dict lookups, not per-row digests.
"""

from __future__ import annotations

import zlib

import numpy as np

from spark_bagging_tpu_torch.utils.io import ChunkSource


class FeatureHasher:
    """Signed feature hashing of categorical columns to dense float32.

    ``transform_columns(cols)`` takes a list of ``(n,)`` arrays (any
    dtype; values are stringified) and returns ``(n, n_features)``
    where each column's token ``"<j>=<value>"`` adds ±1 at its hashed
    index. Deterministic for a given ``seed``.
    """

    # beyond this many distinct values per column the memo stops
    # growing (Criteo categorical columns reach 10M+ uniques; crc32 is
    # C-speed, so uncached hashing is fine for the long tail)
    _MEMO_CAP = 1 << 20

    def __init__(self, n_features: int = 1024, seed: int = 0):
        if n_features < 2:
            raise ValueError(f"n_features must be >= 2, got {n_features}")
        self.n_features = n_features
        self.seed = seed
        # per-column memo: value -> (index, sign), size-capped
        self._memo: dict[int, dict[object, tuple[int, float]]] = {}

    def _slot(self, col: int, value: object) -> tuple[int, float]:
        memo = self._memo.setdefault(col, {})
        hit = memo.get(value)
        if hit is None:
            # surrogateescape restores any non-UTF-8 input bytes
            # verbatim, keeping token bytes native-reader-identical
            token = f"{col}={value}".encode("utf-8", "surrogateescape")
            h = zlib.crc32(token, self.seed & 0xFFFFFFFF)
            idx = h % self.n_features
            # The sign must come from a hash of DIFFERENT BYTES, not a
            # different crc init: crc32 is affine in its init, so for
            # equal-length tokens (Criteo's fixed-width hex values!)
            # two inits differ by a constant and colliding tokens
            # would always share a sign — collisions would add, never
            # cancel, biasing every hashed feature upward.
            sign = 1.0 if zlib.crc32(token + b"#", self.seed & 0xFFFFFFFF) & 1 else -1.0
            hit = (idx, sign)
            if len(memo) < self._MEMO_CAP:
                memo[value] = hit
        return hit

    def transform_columns(self, cols: list[np.ndarray]) -> np.ndarray:
        if not cols:
            raise ValueError("transform_columns needs at least one column")
        n = len(cols[0])
        out = np.zeros((n, self.n_features), np.float32)
        rows = np.arange(n)
        for j, col in enumerate(cols):
            if len(col) != n:
                raise ValueError("columns must share a length")
            # vectorize through the vocabulary: factorize once, hash
            # each unique value once
            values, inverse = np.unique(np.asarray(col, dtype=object),
                                        return_inverse=True)
            idx = np.empty(len(values), np.int64)
            sign = np.empty(len(values), np.float32)
            for k, v in enumerate(values):
                idx[k], sign[k] = self._slot(j, v)
            np.add.at(out, (rows, idx[inverse]), sign[inverse])
        return out


class HashedCSVChunks(ChunkSource):
    """Chunked CSV reader that hashes categorical columns host-side.

    Yields dense ``(chunk_rows, n_numeric + n_hash)`` blocks: numeric
    columns pass through (empty fields → 0, the Criteo convention),
    categorical columns are signed-hashed into ``n_hash`` slots. This
    is the raw-Criteo ingestion path: the device only ever sees
    dense blocks, so every streaming engine (SGD, multi-pass trees,
    streamed OOB/scoring) works unchanged on categorical data.
    """

    def __init__(
        self,
        path: str,
        *,
        chunk_rows: int,
        label_col: int = 0,
        numeric_cols: list[int] | None = None,
        categorical_cols: list[int] | None = None,
        n_hash: int = 1024,
        seed: int = 0,
        delimiter: str = ",",
        skip_header: bool = False,
        n_rows: int | None = None,
    ):
        if not categorical_cols and not numeric_cols:
            raise ValueError(
                "need numeric_cols and/or categorical_cols"
            )
        self._path = path
        self._label_col = label_col
        self._numeric = list(numeric_cols or [])
        self._categorical = list(categorical_cols or [])
        self._delim = delimiter
        self._skip_header = skip_header
        self._hasher = FeatureHasher(n_hash, seed)
        self.chunk_rows = int(chunk_rows)
        # hashed slots exist only when categorical columns do — the
        # declared width must match what _encode actually emits
        self.n_features = len(self._numeric) + (
            n_hash if self._categorical else 0
        )
        # pass n_rows to skip the counting pass (a Criteo-scale file
        # should not be read twice), as the sibling CSV/libsvm sources
        # allow
        self.n_rows = self._count_rows() if n_rows is None else int(n_rows)

    def _count_rows(self) -> int:
        from spark_bagging_tpu_torch.utils.host_native import get_lib

        lib = get_lib()
        if lib is not None:
            n = lib.csv_count_rows(
                self._path.encode(), int(self._skip_header)
            )
            if n >= 0:
                return int(n)
        n = 0
        with open(self._path, "rb") as f:
            skipped = not self._skip_header
            for line in f:
                if not line.strip():
                    continue
                if not skipped:
                    skipped = True
                    continue
                n += 1
        return n

    @staticmethod
    def _field_float(field: str) -> float:
        """float() with empty→0 and underscores rejected — Python's
        float accepts "1_0" but C strtof (the native reader) does not;
        rejecting on both paths keeps them bit-identical."""
        if not field:
            return 0.0
        if "_" in field:
            raise ValueError(f"invalid numeric field {field!r}")
        return float(field)

    def _encode(self, rows: list[list[str]]):
        n = len(rows)
        y = np.empty((n,), np.float32)
        num = np.zeros((n, len(self._numeric)), np.float32)
        for i, parts in enumerate(rows):
            y[i] = self._field_float(parts[self._label_col])
            for j, c in enumerate(self._numeric):
                num[i, j] = self._field_float(parts[c])
        cats = [
            np.array([r[c] for r in rows], dtype=object)
            for c in self._categorical
        ]
        if cats:
            hashed = self._hasher.transform_columns(cats)
            X = np.concatenate([num, hashed], axis=1) if self._numeric \
                else hashed
        else:
            X = num
        return X.astype(np.float32), y

    def _iter_raw(self):
        """Deterministic line order (required by the chunk-keyed weight
        streams); the base class buffers and pads to fixed shape.

        Uses the native C++ reader when available (same crc32 token
        stream — differential-tested); the pure-Python path below is
        the portable fallback.
        """
        from spark_bagging_tpu_torch.utils.host_native import (
            NativeReader,
            note_served,
        )

        try:
            reader = NativeReader.open_csv_hashed(
                self._path, self.chunk_rows,
                label_col=self._label_col,
                numeric_cols=self._numeric,
                categorical_cols=self._categorical,
                n_hash=self._hasher.n_features,
                seed=self._hasher.seed,
                delimiter=self._delim,
                skip_header=self._skip_header,
            )
        except OSError:
            reader = None
        if reader is not None:
            note_served("native")
            yield from reader
            return
        note_served("python")
        # binary read, LF line split: the same framing as the native
        # getline reader and _count_rows — a lone-\r (classic-Mac)
        # file is NOT treated as multi-line on any path (text-mode
        # universal newlines would, silently desyncing n_rows from the
        # chunk stream). LF and CRLF files are the supported formats.
        buf: list[list[str]] = []
        with open(self._path, "rb") as f:
            skipped = not self._skip_header
            for raw in f:
                if not raw.strip():
                    continue
                if not skipped:
                    skipped = True
                    continue
                # surrogateescape keeps non-UTF-8 bytes round-trippable
                # so the hashed token bytes stay identical to the
                # byte-agnostic native reader's — the differential
                # parity contract must hold for any input bytes
                line = raw.decode(
                    "utf-8", "surrogateescape"
                ).rstrip("\r\n")
                buf.append(line.split(self._delim))
                if len(buf) == self.chunk_rows:
                    yield self._encode(buf)
                    buf = []
        if buf:
            yield self._encode(buf)
