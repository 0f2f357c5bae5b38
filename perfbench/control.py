"""The readings a cell's limits are set from: the compared numbers of
sound runs of the program over many seeds, and of the control.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3
                                 [--control-seeds 4,5,6]

For each seed the cell's loop (``perfbench/loops/<loop>.py``) runs as a
run drives it, at the cell's own size: its set-up, then one call of the
window, judged by the cell's reference as ``run.py`` judges a window.
Then, for each control seed, the control is judged in the program's
place. The configuration's ``control`` block says, for each loop, what
the control is: either the program with a lower-precision path of its
own switched on (``program``: laid over the configuration), or the
reference itself computed lower (``reference``: the loop's
``control``, which puts the reference's lower computation in place of
what the call produced). One JSON line a reading, then the largest
program reading and the smallest control reading of each number. The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.getcwd()


def _seeds(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x]


def readings(c, seed: int, control: bool, device: str = "cuda",
             sizes: dict | None = None) -> dict:
    """The cell's compared numbers on one seed, of the program or of
    its control."""
    import torch

    from bench import cell as cells
    from bench import drive

    cfg = drive.merge(c.config, sizes)
    name = c.traffic["loop"]
    lower = cfg["control"][name].get("program") if control else None
    cfg = drive.merge(cfg, lower)
    loop = cells.loop(name, c.base)
    run = drive.context(cfg, seed, device)
    loop.setup(run)
    _, rec = loop.call(run, 0)
    if rec is not None:
        run.records.append(rec)
    run.state = None
    if run.cuda:
        torch.cuda.empty_cache()
    ref = drive.reference(run)
    if control and lower is None:
        loop.control(run, ref)
    return loop.numbers(run, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, required=True)
    p.add_argument("--control-seeds", type=_seeds, default=[])
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    from bench import cell, guard

    c = cell.load(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    worst: dict[str, float] = {}
    least: dict[str, float] = {}
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            nums = readings(c, seed, control)
            print(json.dumps({"cell": c.name, "seed": seed,
                              "control": control, "numbers": nums,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            for k, v in nums.items():
                agg = least if control else worst
                agg[k] = (min if control else max)(agg.get(k, v), v)
            torch.cuda.empty_cache()
    print(json.dumps({"cell": c.name, "lower": worst, "control_least": least,
                      "limits": c.limits,
                      "forbidden": guard.forbidden_modules()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
