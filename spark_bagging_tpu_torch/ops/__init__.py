"""Device ops: threefry keys, bootstrap draws, aggregation, the
hand-written kernels' wrappers and their seam (``kernels.py``), the
precision policy and the profiler range that the entry points open
(``ranges.py``)."""
