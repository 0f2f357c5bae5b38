"""The benchmark harness of the PyTorch/CUDA port (``run.py``)."""
