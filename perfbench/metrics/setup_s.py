"""Seconds from process start to the window's start: loading, the data
from the seed, the loop's warm-up (and a first run's kernel build)."""


def read(run):
    return run.setup_s
