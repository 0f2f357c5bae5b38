"""Arrow ingestion: parquet / feather / Arrow IPC → host matrices.

A copy of the JAX package's ``utils/arrow.py`` (host numpy and
pyarrow):

- :func:`load_arrow` — whole-file parquet / feather / Arrow-IPC →
  ``(X, y)`` float32 host matrices. Per-feature columns decode through
  a column→row transpose; a single fixed-size-list feature column is
  the row-major block already and decodes at disk speed;
- :func:`write_row_major_ipc` — the producer of that row-major layout;
- :class:`ArrowChunks` — a :class:`~spark_bagging_tpu_torch.utils.io.ChunkSource`
  streaming record batches for the out-of-core engines
  (``fit_stream``) without materializing the file.

pyarrow is an optional dependency: every entry point raises a clear
ImportError when it is missing. ``ArrowChunks`` is a top-level export,
so the pyarrow import stays deferred inside ``_pyarrow()``: a
module-level ``import pyarrow`` would break ``import
spark_bagging_tpu_torch`` for every install without it.
"""

from __future__ import annotations

import numpy as np

from spark_bagging_tpu_torch.utils.io import ChunkSource


def _pyarrow():
    try:
        import pyarrow  # noqa: F401
    except ImportError as e:  # pragma: no cover - env without pyarrow
        raise ImportError(
            "Arrow ingestion needs pyarrow (optional dependency); "
            "install it or use the CSV/libsvm/numpy paths"
        ) from e
    return pyarrow


def _is_parquet(path: str) -> bool:
    if path.endswith((".parquet", ".pq")):
        return True
    if path.endswith((".feather", ".arrow", ".ipc")):
        return False
    # sniff: parquet files start and end with the magic bytes "PAR1"
    with open(path, "rb") as f:
        return f.read(4) == b"PAR1"


def _resolve_label(names: list[str], label_col: int | str) -> str:
    if isinstance(label_col, str):
        if label_col not in names:
            raise ValueError(
                f"label column {label_col!r} not in schema {names}"
            )
        return label_col
    idx = label_col + len(names) if label_col < 0 else label_col
    if not 0 <= idx < len(names):
        raise ValueError(
            f"label_col {label_col} out of range for {len(names)} columns"
        )
    return names[idx]


def _resolve_columns(
    names: list[str],
    label_col: int | str,
    columns: list[str] | None,
) -> tuple[str, list[str]]:
    """Shared label + feature-column resolution for both entry points."""
    label = _resolve_label(names, label_col)
    if columns is not None:
        missing = [c for c in columns if c not in names]
        if missing:
            raise ValueError(f"columns {missing} not in schema {names}")
    feats = [
        n for n in (columns if columns is not None else names)
        if n != label
    ]
    if not feats:
        raise ValueError("no feature columns left after removing label")
    return label, feats


def _fsl_width(typ) -> int | None:
    """Width of a fixed-size-list-of-numbers column, else None."""
    import pyarrow as pa

    if pa.types.is_fixed_size_list(typ) and (
        pa.types.is_floating(typ.value_type)
        or pa.types.is_integer(typ.value_type)
    ):
        return int(typ.list_size)
    return None


def _batch_to_xy(
    batch, feature_names: list[str], label_name: str
) -> tuple[np.ndarray, np.ndarray]:
    """One Arrow record batch → dense (X, y) float32/float32."""
    import pyarrow as pa

    # y cast matches the docstring contract AND every sibling loader
    # (csv/libsvm/hashed yield float32 labels) — int64 labels from a
    # parquet column otherwise ride through chunk padding and host-side
    # comparisons at a different dtype than the same data via CSV
    y = np.asarray(
        batch.column(label_name).to_numpy(zero_copy_only=False),
        np.float32,
    )
    cols = [batch.column(name) for name in feature_names]
    cols = [
        c.combine_chunks() if isinstance(c, pa.ChunkedArray) else c
        for c in cols  # Table path (load_arrow)
    ]
    if any(_fsl_width(c.type) is not None for c in cols):
        # guard shared by BOTH entry points (ArrowChunks also rejects
        # at init, for the earlier error): a list column mixed with
        # scalar features would otherwise die in np.stack with a
        # cryptic "setting an array element with a sequence"
        if len(cols) > 1:
            raise ValueError(
                "a fixed-size-list feature column must be the ONLY "
                f"feature column, got {feature_names}"
            )
        col = cols[0]
        # Row-major feature block: the values buffer already IS the
        # (n, d) matrix, so decode skips the column→row transpose that
        # bounds the per-feature layout for wide data.
        if col.null_count:
            raise ValueError(
                f"feature column {feature_names[0]!r} has "
                f"{col.null_count} null rows — flatten() would "
                "silently misalign the reshape"
            )
        d = col.type.list_size
        # flatten() (not .values) honors slice offsets
        X = col.flatten().to_numpy(zero_copy_only=False)
        return np.ascontiguousarray(
            X.reshape(len(col), d).astype(np.float32, copy=False)
        ), y
    X = np.stack(
        [c.to_numpy(zero_copy_only=False) for c in cols], axis=1
    ).astype(np.float32, copy=False)
    return np.ascontiguousarray(X), y


def load_arrow(
    path: str,
    *,
    label_col: int | str = -1,
    columns: list[str] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Whole-file parquet / feather / IPC → ``(X, y)``.

    ``label_col`` selects the target by column name or index (negative
    counts from the end, default: last column); ``columns`` optionally
    restricts the feature set (label excluded automatically).
    """
    _pyarrow()

    if _is_parquet(path):
        import pyarrow.parquet as pq

        label, feats = _resolve_columns(
            pq.read_schema(path).names, label_col, columns
        )
        # column projection: decode only the needed columns
        table = pq.read_table(path, columns=feats + [label])
    else:
        import pyarrow as pa

        with pa.memory_map(path) as source:
            table = pa.ipc.open_file(source).read_all()
        label, feats = _resolve_columns(
            table.column_names, label_col, columns
        )
    return _batch_to_xy(table, feats, label)


def write_row_major_ipc(
    path: str,
    X: np.ndarray,
    y: np.ndarray,
    *,
    chunk_rows: int | None = None,
    label_dtype=None,
) -> None:
    """Write ``(X, y)`` as the row-major fast-lane Arrow IPC layout:
    ONE fixed-size-list ``features`` column (the (n, d) block itself —
    decode is a zero-copy reshape, see ``_batch_to_xy``) plus a
    ``label`` column, in record batches of ``chunk_rows``.

    This is the canonical producer for the layout every fast-lane
    consumer (``ArrowChunks``, ``load_arrow``) recognizes; benchmarks,
    examples, and tests all write through here so the format has one
    definition."""
    pa = _pyarrow()

    X = np.ascontiguousarray(X, np.float32)
    y = np.asarray(y)
    if label_dtype is not None:
        y = y.astype(label_dtype)
    fsl = pa.FixedSizeListArray.from_arrays(
        pa.array(X.reshape(-1)), X.shape[1]
    )
    table = pa.table({"features": fsl, "label": y})
    with pa.OSFile(path, "wb") as sink, pa.ipc.new_file(
        sink, table.schema
    ) as writer:
        for batch in table.to_batches(
            max_chunksize=chunk_rows or len(y) or 1
        ):
            writer.write_batch(batch)


class ArrowChunks(ChunkSource):
    """Stream a parquet/feather file in fixed-shape chunks.

    Row count comes from file metadata (no scan); record batches are
    re-blocked to ``chunk_rows`` by the base class. Deterministic batch
    order (file order), so per-chunk bootstrap-weight regeneration is
    exact across epochs [utils/io.py].
    """

    def __init__(
        self,
        path: str,
        chunk_rows: int,
        *,
        label_col: int | str = -1,
        columns: list[str] | None = None,
    ):
        _pyarrow()
        self.path = path
        self.chunk_rows = int(chunk_rows)
        self._parquet = _is_parquet(path)
        if self._parquet:
            import pyarrow.parquet as pq

            pf = pq.ParquetFile(path)
            names = [
                pf.schema_arrow.field(i).name
                for i in range(len(pf.schema_arrow))
            ]
            types = {n: pf.schema_arrow.field(n).type for n in names}
            self.n_rows = int(pf.metadata.num_rows)
        else:
            import pyarrow as pa

            # feather V2 == Arrow IPC; memory-mapped open is zero-copy,
            # so counting rows touches only record-batch metadata
            with pa.memory_map(path) as source:
                reader = pa.ipc.open_file(source)
                names = reader.schema.names
                types = {n: reader.schema.field(n).type for n in names}
                self.n_rows = sum(
                    reader.get_batch(i).num_rows
                    for i in range(reader.num_record_batches)
                )
        self._label, self._features = _resolve_columns(
            names, label_col, columns
        )
        # Row-major fast path: ONE fixed-size-list feature column is the
        # whole (n, d) block (decode = reshape, no transpose) — write
        # wide data this way when you control the producer
        # (write_row_major_ipc does).
        widths = [_fsl_width(types[f]) for f in self._features]
        if any(w is not None for w in widths):
            if len(self._features) > 1:
                raise ValueError(
                    "a fixed-size-list feature column must be the ONLY "
                    f"feature column, got {self._features}"
                )
            self.n_features = widths[0]
        else:
            self.n_features = len(self._features)

    def _iter_raw(self):
        yield from self._iter_raw_from(0)

    def _iter_raw_from(self, start_chunk: int):
        """Row-exact seek for ``chunks_from`` (checkpoint resume): IPC
        record batches are randomly accessible and parquet row groups
        skip by metadata, so resuming late in a big file costs metadata
        reads instead of re-ingesting (and re-decoding) every chunk
        before the cursor — the base class's consume-and-discard
        fallback did exactly that."""
        skip = start_chunk * self.chunk_rows
        if self._parquet:
            import pyarrow.parquet as pq

            pf = pq.ParquetFile(self.path)
            groups: list[int] = []
            for g in range(pf.num_row_groups):
                n = pf.metadata.row_group(g).num_rows
                if skip >= n:
                    skip -= n
                    continue
                groups = list(range(g, pf.num_row_groups))
                break
            for batch in pf.iter_batches(
                batch_size=self.chunk_rows, row_groups=groups,
                columns=self._features + [self._label],
            ):
                if skip:
                    if skip >= batch.num_rows:
                        skip -= batch.num_rows
                        continue
                    batch = batch.slice(skip)
                    skip = 0
                yield _batch_to_xy(batch, self._features, self._label)
        else:
            import pyarrow as pa

            with pa.memory_map(self.path) as source:
                reader = pa.ipc.open_file(source)
                for i in range(reader.num_record_batches):
                    b = reader.get_batch(i)
                    if skip >= b.num_rows:
                        skip -= b.num_rows  # metadata-only skip
                        continue
                    if skip:
                        b = b.slice(skip)
                        skip = 0
                    yield _batch_to_xy(b, self._features, self._label)
