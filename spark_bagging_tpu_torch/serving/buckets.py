"""Shape-bucket math: power-of-two row buckets for zero-capture serving.

A copy of the JAX package's ``serving/buckets.py`` (host-only). A CUDA
graph is captured for one input SHAPE, as XLA compiles one executable
per shape. Online traffic brings a new row count on nearly every
request, so capturing per request would capture constantly — the exact
failure mode the serving subsystem exists to remove. The fix is the
standard one: quantize row counts to a small ladder of power-of-two buckets, pad each
batch up to its bucket, and slice the padding back off the output. The
ladder between ``min_rows`` and ``max_rows`` has ``log2(max/min) + 1``
rungs, so steady-state traffic touches a FINITE set of shapes: after
one warmup pass over the ladder, no request can ever trigger another
capture (counted by ``sbt_serving_compiles_total``).

Padding rows are zeros. They flow through the ensemble forward like any
other row and produce garbage outputs — which is fine, because bagging
aggregation is strictly row-local (vote/mean over replicas, per row):
a padded row can never contaminate a real row's result. The executor
slices ``[:n]`` before anything user-visible happens; the
padding-never-leaks property is tested bitwise.
"""

from __future__ import annotations

import numpy as np

#: Default bucket ladder bounds — 8..4096 rows covers single-row
#: requests (padded 8x at worst, still one tile) up to the largest
#: micro-batch the default batcher will coalesce.
DEFAULT_MIN_ROWS = 8
DEFAULT_MAX_ROWS = 4096


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    return 1 << (int(n) - 1).bit_length()


def bucket_for(n: int, min_rows: int = DEFAULT_MIN_ROWS,
               max_rows: int = DEFAULT_MAX_ROWS) -> int:
    """The bucket (padded row count) a batch of ``n`` rows runs in.

    Bounds are normalized to powers of two first (exactly as
    :func:`bucket_ladder` normalizes them), so every value this can
    return is a ladder rung — the zero-recompile-after-warmup contract
    must hold for ANY bounds, not just power-of-two ones. ``n`` above
    ``max_rows`` still maps to the top rung — the executor splits
    oversized batches into top-bucket slabs first, so the
    compiled-shape set stays bounded by the ladder no matter what a
    caller submits.
    """
    if n < 1:
        raise ValueError(f"batch must have >= 1 row, got {n}")
    return max(next_pow2(min_rows), min(next_pow2(n), next_pow2(max_rows)))


def bucket_ladder(min_rows: int = DEFAULT_MIN_ROWS,
                  max_rows: int = DEFAULT_MAX_ROWS) -> tuple[int, ...]:
    """Every bucket between the bounds — the warmup compile set."""
    if not (1 <= min_rows <= max_rows):
        raise ValueError(
            f"need 1 <= min_rows <= max_rows, got {min_rows}, {max_rows}"
        )
    lo, hi = next_pow2(min_rows), next_pow2(max_rows)
    out = []
    b = lo
    while b <= hi:
        out.append(b)
        b *= 2
    return tuple(out)


def pack_plan(n: int, min_rows: int = DEFAULT_MIN_ROWS,
              max_rows: int = DEFAULT_MAX_ROWS) -> tuple[int, ...]:
    """Slab buckets for serving ``n`` rows with the least padded work.

    A single bucket wastes up to half its rows (``n`` just past a rung
    pads nearly 2x): 20 rows in bucket 32 burns 12 padding rows — 37%
    of the forward's FLOPs. Decomposing the batch into a descending
    run of FULL smaller rungs instead (``20 -> 16 + 8``, only the last
    slab padded) never pads more rows than the single bucket and often
    pads far fewer, at the cost of one extra executable launch per
    extra slab. This returns that plan:

    - row counts above the top rung emit full top-rung slabs first
      (the existing oversize-slab rule, unchanged);
    - the residual is decomposed greedily into full rungs, adjacent
      equal rungs are re-merged (two half slabs over the same rows ARE
      the double slab — same padding, one fewer launch), and the
      decomposition is kept only when it saves at least a QUARTER of
      the single bucket's rows: an extra executable launch has a real
      fixed cost, and shaving a couple of padding rows does not buy it
      back (the single bucket wins all ties and near-ties);
    - every element is a ladder rung, so the compile-shape universe is
      still exactly :func:`bucket_ladder` — zero-recompile-after-warmup
      survives ragged packing.

    Fill rule for consumers: slabs are ordered so only the LAST one is
    partial — walk the plan assigning ``min(bucket, remaining)`` rows
    to each slab.
    """
    if n < 1:
        raise ValueError(f"batch must have >= 1 row, got {n}")
    lo, hi = next_pow2(min_rows), next_pow2(max_rows)
    if lo > hi:
        raise ValueError(
            f"need min_rows <= max_rows, got {min_rows}, {max_rows}"
        )
    plan: list[int] = []
    while n > hi:
        plan.append(hi)
        n -= hi
    # residual in [1, hi]: greedy binary decomposition into full rungs
    greedy: list[int] = []
    r = n
    while r:
        b = max(lo, next_pow2(r))
        if r == b or b // 2 < lo:
            greedy.append(b)  # exact fit, or the floor rung (padded)
            r = 0
        else:
            greedy.append(b // 2)  # full slab; recurse on the rest
            r -= b // 2
    # re-merge equal tail rungs ([.., 8, 8] -> [.., 16], cascading):
    # identical row coverage, strictly fewer launches
    while len(greedy) >= 2 and greedy[-1] == greedy[-2]:
        greedy[-2:] = [greedy[-1] * 2]
    single = max(lo, next_pow2(n))
    saved = single - sum(greedy)
    if len(greedy) > 1 and saved * 4 >= single:
        plan.extend(greedy)
    else:
        plan.append(single)
    return tuple(plan)


def pad_to_bucket(X: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad ``X``'s rows up to ``bucket`` (host-side; the padded
    block is the h2d transfer unit)."""
    n = X.shape[0]
    if n > bucket:
        raise ValueError(f"{n} rows do not fit bucket {bucket}")
    if n == bucket:
        return X
    Xp = np.zeros((bucket,) + X.shape[1:], X.dtype)
    Xp[:n] = X
    return Xp
