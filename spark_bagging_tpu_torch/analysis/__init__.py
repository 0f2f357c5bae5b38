"""Analysis tools of the port: the lock-order checker (``locks.py``) the
serving plane and the telemetry registry take their locks from."""
