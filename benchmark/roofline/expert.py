"""The expert layer's grouped products (``moe_gemm_kernel``: the gate/up
and the down launch of ``kernels/moe.py:experts``) in the Moonlight
narrator's decode steps. Per expert layer and step, ``T`` tokens each
routed to ``k`` of ``E`` experts, and every token to the ``S`` shared
experts of the same shape (SwiGLU of width ``I`` on ``D``): N = T·k + S·T
rows. Bytes: the weights of every expert that got a row (the routed ones
with a row, and the shared ones), each read once, plus the rows read and
written (x's N gathered rows and h's N rows out; h's N rows in and y's N
rows out). Operations: 2 × N × (2I·D + D·I). The routing, sort and
combine kernels are not in the share.

The decoder replays its cached steps as CUDA graphs, which do not call
the expert layer's Python entry point again: the probe counts the decode
steps at the sampler instead (one call a step, outside the graphs, with
the step's rows ``T``), and the routed experts with a row come from the
port's counters (``moe.used.<layer>``, Σ over the layer's calls of the
experts that got a row, over its calls, ``moe.rows.<layer>``'s routed
rows ÷ ``T·k``): their mean a call over every counted call (the warm-up
batch and both windows) stands for each traced step's."""

from __future__ import annotations

from benchmark.roofline import share

PATTERN = r"\bmoe_gemm_kernel"
# one call a decode step, outside the decoder's CUDA graphs
STEP = "lavila_tpu_torch.models.sampling.sample_token"
ITEM = {"bfloat16": 2, "float32": 4}


def _record(generator, logits):
    return logits.shape[0]


PROBES = {STEP: _record}


def layer_cost(T: int, k: int, S: int, D: int, I: int, used: float,
               it: int) -> tuple[float, float]:
    """(bytes, operations) of one expert layer's grouped products over
    ``T`` tokens, ``used`` routed experts having got a row."""
    N = T * k + S * T
    return ((used + S) * 3 * I * D * it + 2 * N * (D + I) * it,
            2 * N * 3 * I * D)


def used_per_call(counters: dict, T: int, k: int) -> list[float]:
    """Each expert layer's mean count of routed experts with a row a call
    (calls: the layer's routed rows ÷ ``T·k``), from the port's counters;
    empty without them."""
    out = []
    for name, used in sorted(counters.items()):
        if not name.startswith("moe.used."):
            continue
        rows = counters.get("moe.rows." + name[len("moe.used."):])
        calls = 0.0 if rows is None else float(rows.sum()) / (T * k)
        if calls > 0:
            out.append(float(used) / calls)
    return out


def roofline(run, tracing) -> float | None:
    """The share, or None where the program keeps no routing counters."""
    if tracing is None or not hasattr(tracing, "counters"):
        return None
    cfg, t = run.cfg, run.traffic
    k, S = cfg["num_experts_per_tok"], cfg["n_shared_experts"]
    D, I = cfg["hidden_size"], cfg["moe_intermediate_size"]
    it = ITEM[cfg["dtype"]]
    used = used_per_call(tracing.counters(), t["batch"] * t["sampling"][
        "num_return_sequences"], k)
    if not used:
        return None

    def cost(target: str, rows: int) -> tuple[float, float, str]:
        layers = [layer_cost(rows, k, S, D, I, u, it) for u in used]
        return (sum(b for b, _ in layers), sum(f for _, f in layers),
                "bfloat16")

    return share(run, PATTERN, PROBES, cost)
