#!/usr/bin/env python3
"""Time the host cost of one span of ``lavila_tpu_torch/utils/tracing.py``
on the card, in the states a run meets:

  * ``off``: recording off (every end-to-end run): ``span()`` and its
    shared null context;
  * ``on``: recording on with CUDA in use: the span's record and its two
    CUDA events, from the pool after the first ``spans()``;
  * ``on_profiled``: the same under ``torch.profiler`` (CPU and CUDA),
    which adds a ``record_function`` range;
  * ``resolve``: ``spans()`` filling in each span's ``device_ms`` (one
    synchronise, then two events read a span);
  * ``loop``: the bare Python loop the others run in, not subtracted.

Each is ``--n`` flat spans, the mean of ``--repeats`` rounds in ns a
span; one JSON line, after the card's name and power limit:

    python scripts/time_spans.py [--n 20000] [--repeats 5]
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _loop_ns(n: int, body) -> float:
    t0 = time.perf_counter_ns()
    body(n)
    return (time.perf_counter_ns() - t0) / n


def main(argv=None) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lavila_tpu_torch.utils import tracing
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=20000)
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("time_spans: needs a card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        flush=True)
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()

    def spans(n):
        for _ in range(n):
            with tracing.span("time_spans"):
                pass

    def loop(n):
        for _ in range(n):
            pass

    out = {k: [] for k in ("loop", "off", "on", "on_profiled", "resolve")}
    for _ in range(args.repeats):
        out["loop"].append(_loop_ns(args.n, loop))
        tracing.disable()
        out["off"].append(_loop_ns(args.n, spans))
        tracing.enable()
        spans(args.n)  # fills the events' pool
        tracing.spans()
        tracing.reset()
        out["on"].append(_loop_ns(args.n, spans))
        t0 = time.perf_counter_ns()
        tracing.spans()
        out["resolve"].append((time.perf_counter_ns() - t0) / args.n)
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            out["on_profiled"].append(_loop_ns(args.n, spans))
        tracing.spans()
        tracing.reset()
        tracing.disable()
    print(json.dumps({"n": args.n, "ns_per_span": {
        k: round(sum(v) / len(v), 1) for k, v in out.items()},
        "rounds": {k: [round(x, 1) for x in v] for k, v in out.items()}}),
        flush=True)


if __name__ == "__main__":
    main()
