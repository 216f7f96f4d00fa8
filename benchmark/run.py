#!/usr/bin/env python3
"""Run one cell of the benchmark of ``lavila_tpu_torch`` once, on the
cards of the machine it is started on, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device`` and, traced, the
``breakdown``; its last key, ``checks``, holds each number that decided
``correct`` beside its limit, and so do the last lines of standard
error. Earlier lines (``bench-info``) hold the card's name and power
limit, the set-up's stages, the window's units and the launches per
unit. Without the cards the cell asks for, or with a module of JAX or of
the JAX package loaded, the run exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.portbench import files, guard  # noqa: E402
from benchmark.portbench.trace import ReaderFault  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    guard.set_env(ROOT)
    cell = files.workload(args.workload, ROOT)
    try:
        guard.require_device(cell["chips"])
    except guard.NoDevice as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    from benchmark.portbench import harness
    harness.info(device=guard.power_limit(), chips=cell["chips"])
    try:
        result, _ = harness.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), "cuda", ROOT, T_START)
    except guard.ForbiddenImport as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 4
    except ReaderFault as e:
        print(f"benchmark: a per-layer reader failed: {e}", file=sys.stderr)
        return 5
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
