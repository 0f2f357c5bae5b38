"""Device ops: threefry keys, bootstrap draws, aggregation, the
scaled-Gram kernel, the precision policy and the profiler range that the
entry points open (``ranges.py``)."""
