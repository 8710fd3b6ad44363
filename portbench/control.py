#!/usr/bin/env python3
"""The readings that the check's limits are set from, on the card: the
program's sound runs and the control's, and each fault of faults.py,
on several seeds, one set-up a seed.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 5 [--modes sound,control,stale,half,altered]

Each mode gets its own short window on the same inputs and prints one
line of JSON: the seed, the mode, `correct`, the calls, and every number
compared.  The benchmark's own runs (run.py) plant nothing.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--modes", default="sound,control,stale,half,altered")
    args = p.parse_args(argv)
    cell = run.load_cell(args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        setup = {"interpreter": 0.0, "imports": 0.0}
        h, r, setup_s = run.set_up(cell, seed, "cuda", setup)
        for mode in args.modes.split(","):
            got = run.measure(h, r, args.seconds, False, setup_s,
                              None if mode == "sound" else mode)
            print(json.dumps({"cell": cell.name, "seed": seed, "mode": mode,
                              "correct": got["correct"],
                              "attempted": got["attempted"],
                              "failed": got["failed"],
                              "frames_checked": got["frames_checked"],
                              "checks": {k: v["value"] for k, v in
                                         got["checks"].items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
