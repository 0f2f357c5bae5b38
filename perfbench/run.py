"""The benchmark of the PyTorch/CUDA port: one cell, run once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Run from the root of a checkout. The cell, its configuration, traffic
mix, limits and per-layer metrics are found by name from
``BENCHMARK.json`` (``bench/cell.py``). The run loads the port, makes
its data from the seed, warms every shape the window uses, measures for
``--seconds`` (``--trace 1``: profiles the window and reads the
per-layer metrics instead), checks what the window produced against the
plain reference, prints each compared number beside its limit as the
last lines of standard error and one JSON object as the last line of
standard output. It exits non-zero, printing no result, without a CUDA
device, when JAX or the JAX package got loaded, or when anything fails.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.getcwd()
CACHE = os.path.join(HERE, ".cache")


def _environment() -> None:
    """Fixed cache directories inside the checkout, so that only a
    cell's first run there builds or compiles anything; no library the
    port uses loads JAX."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    sys.path[:0] = [HERE, ROOT]

    from bench import cell, guard

    c = cell.load(args.workload, ROOT)
    t0 = time.perf_counter()
    import torch

    t1 = time.perf_counter()
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device; the benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(c.workload["chips"]):
        print(f"perfbench: {c.name} needs {c.workload['chips']} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    from bench import drive

    t2 = time.perf_counter()
    starts = {"start": t0 - T_START, "import torch": t1 - t0,
              "card check": t2 - t1}
    result = drive.run(c, args.seed, args.seconds, bool(args.trace),
                       T_START, starts=starts)
    bad = guard.forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
