#!/usr/bin/env python3
"""The readings that set each cell's limits, on the card at the cell's
own size: for each seed, one run of the cell with a short window, its
numbers against the plain reference once for the program and once for
each control (the reference in the program's place one precision step
lower: fp8 products, or fp8 in the attention alone,
``reference/numerics.py``), and for a training cell the reading of a
half batch (the reference's first loss over half the rows); then one
run more for each fault named (``portbench/faults.py``), planted in the
port underneath. The benchmark's own runs do not run the control.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 5] [--faults top_p_ignored,temperature_1]

Prints one JSON line a seed, then the lower reading (the program's
largest) and, by control and fault, the smallest of each number.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.portbench import guard  # noqa: E402


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--faults", default="")
    args = p.parse_args(argv)
    guard.set_env(ROOT)
    from benchmark.portbench import faults, files, harness
    guard.require_device(files.workload(args.workload, ROOT)["chips"])
    lower, upper = {}, {}

    def least(source: str, readings: dict) -> None:
        for k, v in readings.items():
            if isinstance(v, (int, float)):
                d = upper.setdefault(source, {})
                d[k] = min(d.get(k, float("inf")), v)

    for seed in (int(s) for s in args.seeds.split(",")):
        result, extra = harness.run_cell(args.workload, seed, args.seconds,
                                         False, "cuda", ROOT, control=True)
        line = {"seed": seed, "correct": result["correct"],
                "program": {k: c["value"]
                            for k, c in result["checks"].items()},
                "extra": extra}
        print("control " + json.dumps(line), flush=True)
        for k, v in line["program"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        for mode, readings in extra["control"].items():
            least(mode, readings)
        for name in filter(None, args.faults.split(",")):
            with faults.planted(name):
                result, _ = harness.run_cell(args.workload, seed,
                                             args.seconds, False, "cuda",
                                             ROOT)
            readings = {k: c["value"] for k, c in result["checks"].items()}
            print("fault " + json.dumps({"seed": seed, "fault": name,
                                         "correct": result["correct"],
                                         "readings": readings}), flush=True)
            least(name, readings)
    print(json.dumps({"lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
