"""Device ops: threefry keys, bootstrap draws, aggregation, the
scaled-Gram kernel and the precision policy."""
