"""One rank of the port's tensor-parallel and ring-attention CPU tests
(gloo), and the runner that starts a set of them.

    python tests/torch_tp_worker.py SPEC_JSON RANK

``SPEC_JSON`` names the world size, the rendezvous port, the directory
holding ``inputs.pt`` (written by the test), the model-axis size and the
cases to run; the rank writes ``out_{RANK}.pt``. It imports only torch
and the port, so that each rank starts in seconds.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from lavila_tpu_torch.models import build_model  # noqa: E402
from lavila_tpu_torch.models.gpt2 import (GPT2Config, GPT2LMHead,  # noqa: E402
                                          init_cache)
from lavila_tpu_torch.ops import ring_attention as R  # noqa: E402
from lavila_tpu_torch.parallel import mesh, sharding  # noqa: E402
from lavila_tpu_torch.train import optim as O  # noqa: E402
from lavila_tpu_torch.train import step as S  # noqa: E402

torch.set_num_threads(1)

RANK_TIMEOUT = 240  # seconds for a set of ranks, start-up included


def run_ranks(*args, **kwargs) -> list:
    """:func:`start_ranks` then :func:`join_ranks`."""
    return join_ranks(start_ranks(*args, **kwargs))


def start_ranks(tmp, world: int, cases: list, inputs: dict, model: int = 1,
                case_model: dict | None = None, env: dict | None = None):
    """Start ``cases`` on ``world`` gloo ranks (model axis ``model``, or
    ``case_model[case]``), each a process; :func:`join_ranks` waits for
    them."""
    from lavila_tpu_torch.cli.launch import free_port
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, tmp / "inputs.pt")
    spec = tmp / "spec.json"
    spec.write_text(json.dumps({"world": world, "port": free_port(),
                                "dir": str(tmp), "cases": cases,
                                "model": model,
                                "case_model": case_model or {},
                                "timeout": RANK_TIMEOUT}))
    env = {**os.environ, "OMP_NUM_THREADS": "1", **(env or {})}
    logs = [open(tmp / f"log_{r}.txt", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, str(spec), str(r)],
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              env=env, cwd=str(tmp)) for r in range(world)]
    return tmp, procs, logs, time.monotonic() + RANK_TIMEOUT


def join_ranks(started) -> list:
    """The outputs of :func:`start_ranks`' ranks in rank order. A rank
    that fails or outlives the timeout fails the test, every rank
    killed."""
    tmp, procs, logs, deadline = started
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" \
            f"{text[-4000:]}"
    return [torch.load(tmp / f"out_{r}.pt", weights_only=False)
            for r in range(len(procs))]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().copy()


# ------------------------------------------------------ tensor parallelism

def _gpt2(inp) -> GPT2LMHead:
    """The GPT-2 of ``inp`` from its whole state dict, sharded over the
    model group."""
    m = GPT2LMHead(GPT2Config(**inp["cfg"]))
    m.load_state_dict(inp["state_dict"], strict=True)
    return sharding.shard_model(m.eval())


@torch.no_grad()
def gpt2_forward_case(inp) -> dict:
    m = _gpt2(inp)
    ids = torch.as_tensor(inp["ids"]).long()
    logits = m(ids, encoder_states=torch.as_tensor(inp["enc"]))
    return {"logits": _np(logits),
            "local_width": m.cache_width(),
            "heads": [blk.attn.c_proj.in_features // blk.attn.head_dim
                      for blk in m.transformer.h]}


@torch.no_grad()
def gpt2_decode_case(inp) -> dict:
    """Prefill the ids, then 3 greedy cached steps: the stacked last
    logits (as ``tests/test_tensor_parallel.py:136``)."""
    m = _gpt2(inp)
    ids = torch.as_tensor(inp["ids"]).long()
    cfg = m.cfg
    cache = init_cache(cfg, 1, 12, width=m.cache_width())
    cross_kv = m.precompute_cross_kv(torch.as_tensor(inp["enc"]))
    logits = m(ids, cross_kv=cross_kv, cache=cache, cache_index=0)
    outs = [logits[:, -1]]
    tok = logits[:, -1].argmax(-1)[:, None]
    idx = ids.shape[1]
    for _ in range(3):
        logits = m(tok, cross_kv=cross_kv, cache=cache, cache_index=idx)
        outs.append(logits[:, -1])
        tok = logits[:, -1].argmax(-1)[:, None]
        idx += 1
    return {"logits": _np(torch.stack(outs, 1)),
            "cache_shape": list(cache[0][0].shape)}


def tp_step_case(inp) -> dict:
    """Two SGD steps (no momentum; clipped by global norm where ``inp``
    has a ``clip``) of the MINI dual encoder on this data rank's rows of
    two global batches, the model sharded over the model group: metrics,
    the whole masters (gathered), the replicated masters' gradients of
    the last step, and the sharded masters' local and whole shapes."""
    model = build_model(inp["model"], device="cpu", train=True)
    model.load_state_dict(inp["state_dict"], strict=True)
    sharding.shard_model(model)
    state = S.TrainState.create(model, lambda p: O.make_optimizer(
        p, 1e-2, weight_decay=0.0, use_sgd=True,
        clip_grad_value=inp.get("clip")), dtype=torch.float32)
    for group in state.optimizer.inner.param_groups:
        group["momentum"] = 0.0
    mesh.broadcast_params(state)
    step = S.make_clip_train_step(norm_embed=True)
    r, w = mesh.data_rank(), mesh.data_world()
    metrics = []
    for batch in inp["batches"]:
        b = batch["frames"].shape[0] // w
        local = {"frames": torch.as_tensor(batch["frames"][r * b:(r + 1) * b]),
                 "text": torch.as_tensor(
                     batch["text"][r * b:(r + 1) * b]).long()}
        state, m = step(state, local)
        metrics.append({k: v.item() for k, v in m.items()})
    splits = sharding.layout(state.params)
    whole = sharding.gather_state_dict(
        {k: p.detach() for k, p in state.params.items()}, splits)
    return {"metrics": metrics,
            "params": {k: _np(v) for k, v in whole.items()},
            "replicated_grads": {k: _np(p.grad) for k, p in
                                 state.params.items()
                                 if k not in splits and p.grad is not None},
            "sharded": {k: [list(state.params[k].shape),
                            list(whole[k].shape)] for k in splits}}


def tp_caption_case(inp) -> dict:
    """Two SGD steps (lr 1e-2, no momentum) of the MINI narrator's
    caption step, nothing frozen, on this data rank's rows of two global
    batches, the model sharded over the model group (the pooler's
    ``to_kv`` gathered): the losses, the whole masters (gathered) and
    the sharded masters' names."""
    model = build_model(inp["model"], device="cpu", gated_xattn=True,
                        train=True)
    model.load_state_dict(inp["state_dict"], strict=True)
    sharding.shard_model(model)
    state = S.TrainState.create(model, lambda p: O.make_optimizer(
        p, 1e-2, weight_decay=0.0, use_sgd=True), dtype=torch.float32)
    for group in state.optimizer.inner.param_groups:
        group["momentum"] = 0.0
    mesh.broadcast_params(state)
    step = S.make_caption_train_step(pad_id=0)
    r, w = mesh.data_rank(), mesh.data_world()
    losses = []
    for frames, text in inp["batches"]:
        b = frames.shape[0] // w
        local = {"frames": torch.as_tensor(frames[r * b:(r + 1) * b]),
                 "text": torch.as_tensor(text[r * b:(r + 1) * b]).long()}
        state, m = step(state, local)
        losses.append(m["loss"].item())
    splits = sharding.layout(state.params)
    whole = sharding.gather_state_dict(
        {k: p.detach() for k, p in state.params.items()}, splits)
    return {"losses": losses, "sharded": sorted(splits),
            "params": {k: _np(v) for k, v in whole.items()}}


def cli_case(inp, name) -> dict:
    """``main_pretrain`` with the case's arguments in this process group:
    the sharded masters' local and whole shapes, AdamW's moments' shapes
    beside their parameters', the losses, the step and the last step's
    gradients of the masters, averaged over the replicas and gathered to
    the whole layout."""
    from lavila_tpu_torch.cli import main_pretrain as cli
    from lavila_tpu_torch.config import parse_config
    losses = []
    real = cli.make_clip_train_step

    def recorded(**kw):
        fn = real(**kw)

        def run(state, batch):
            state, m = fn(state, batch)
            losses.append(m["loss"].item())
            return state, m
        return run
    cli.make_clip_train_step = recorded
    try:
        state = cli.main(parse_config(cli.TorchPretrainConfig,
                                      inp["cli"][name]))
    finally:
        cli.make_clip_train_step = real
    splits = sharding.layout(state.params)
    opt = state.optimizer.inner
    moments = {k: list(opt.state[state.params[k]]["exp_avg"].shape)
               for k in splits if state.params[k] in opt.state}
    grads = sharding.gather_state_dict(
        {k: p.grad for k, p in state.params.items() if p.grad is not None},
        splits)
    return {"sharded": {k: list(state.params[k].shape) for k in splits},
            "grads": {k: _np(g) for k, g in grads.items()},
            "moments": moments, "losses": losses, "step": state.step,
            "data": [mesh.data_rank(), mesh.data_world()],
            "model": [mesh.model_rank(), mesh.model_world()],
            "frozen_sharded": sorted(set(splits) & state.frozen)}


def layers_case(inp) -> dict:
    """A column layer with its output gathered (7 outputs: 4/3 over two
    ranks) feeding a row layer that slices its replicated input: the
    output, and the gradient with respect to the input."""
    from lavila_tpu_torch.parallel.tensor import (ColumnParallelLinear,
                                                  RowParallelLinear, Split,
                                                  even_sizes)
    g, n = mesh.model_group(), mesh.model_world()
    first, second = torch.nn.Linear(5, 7), torch.nn.Linear(7, 3)
    first.load_state_dict(inp["first"])
    second.load_state_dict(inp["second"])
    col = ColumnParallelLinear(first, Split(0, 1, even_sizes(7, n)), g,
                               gather_output=True)
    row = RowParallelLinear(second, Split(1, 1, even_sizes(7, n)), g,
                            input_is_parallel=False)
    x = torch.as_tensor(inp["x"]).clone().requires_grad_()
    out = row(col(x))
    (out * torch.as_tensor(inp["w"])).sum().backward()
    return {"out": _np(out), "grad": _np(x.grad)}


@torch.inference_mode()
def narrate_case(inp) -> dict:
    """The MINI narrator, sharded over the model group: sampled ids from a
    generator seeded by the rank (the ranks must still agree), greedy
    ids and beam search's."""
    from lavila_tpu_torch.models.beam import BeamDecoder
    model = build_model(inp["model"], device="cpu", gated_xattn=True)
    model.load_state_dict(inp["state_dict"], strict=True)
    sharding.shard_model(model.eval())
    tokens = model.encode_image(torch.as_tensor(inp["frames"]))
    kw = dict(bos_id=inp["bos"], eos_id=inp["bos"], max_text_length=12,
              num_return_sequences=2)
    sampled, _ = model.generate(
        tokens, generator=torch.Generator().manual_seed(100 + mesh.rank()),
        top_p=0.95, **kw)
    greedy, _ = model.generate(tokens, generator=None, top_k=1, **kw)
    beam = BeamDecoder(model, inp["bos"], inp["bos"], max_text_length=12)
    beams = beam.beam_search(tokens, num_beams=3)
    return {"sampled": _np(sampled), "greedy": _np(greedy),
            "beam": np.asarray(beams[0])}


# ---------------------------------------------------------- ring attention

def _rows(a, r, n, dim):
    return torch.as_tensor(np.ascontiguousarray(a)).chunk(n, dim)[r]


def ring_forward_case(inp, causal: bool) -> dict:
    g = mesh.world_group()
    r, n = mesh.rank(), mesh.world()
    q, k, v = (_rows(inp[x], r, n, 2) for x in ("q", "k", "v"))
    return {"out": _np(R.ring_attention(q, k, v, g, causal=causal))}


def ring_grad_case(inp) -> dict:
    """d sum(ring(q, k, v)²) / dq of this rank's shard."""
    g = mesh.world_group()
    r, n = mesh.rank(), mesh.world()
    q = _rows(inp["gq"], r, n, 2).clone().requires_grad_()
    k, v = (_rows(inp[x], r, n, 2) for x in ("gk", "gv"))
    (R.ring_attention(q, k, v, g) ** 2).sum().backward()
    return {"grad": _np(q.grad)}


def time_ring_case(inp) -> dict:
    """divided_time_ring on whole (CLS-separate) inputs: its output, and
    the gradients of a weighted sum of it with respect to every input."""
    g = mesh.world_group()
    ts = [torch.as_tensor(inp["time"][k]).clone().requires_grad_()
          for k in ("cq", "ck", "cv", "qp", "kp", "vp")]
    cls_out, pat = R.divided_time_ring(*ts, g)
    wc, wp = (torch.as_tensor(inp["time"][k]) for k in ("wc", "wp"))
    ((cls_out * wc).sum() + (pat * wp).sum()).backward()
    return {"cls": _np(cls_out), "patches": _np(pat),
            "grads": [_np(t.grad) for t in ts]}


def spacetime_case(inp) -> dict:
    """A SpaceTimeTransformer forward with the ring group set, from the
    test's whole weights."""
    from lavila_tpu_torch.models.timesformer import SpaceTimeTransformer
    model = SpaceTimeTransformer(**inp["tsf"]["kw"]).eval()
    model.load_state_dict(inp["tsf"]["state_dict"], strict=True)
    R.set_ring_group(mesh.world_group())
    try:
        with torch.no_grad():
            out = model(torch.as_tensor(inp["tsf"]["x"]))
    finally:
        R.set_ring_group(None)
    return {"out": _np(out)}


CASES = {
    "gpt2_fwd": lambda inp, arg: gpt2_forward_case(inp[arg]),
    "gpt2_decode": lambda inp, arg: gpt2_decode_case(inp[arg]),
    "tp_step": lambda inp, arg: tp_step_case(inp[arg]),
    "tp_caption": lambda inp, arg: tp_caption_case(inp[arg]),
    "narrate": lambda inp, arg: narrate_case(inp[arg]),
    "layers": lambda inp, arg: layers_case(inp[arg]),
    "cli": cli_case,
    "ring": lambda inp, arg: ring_forward_case(inp, arg == "causal"),
    "ring_grad": lambda inp, arg: ring_grad_case(inp),
    "time_ring": lambda inp, arg: time_ring_case(inp),
    "spacetime": lambda inp, arg: spacetime_case(inp),
}


def main(spec_path: str, r: int) -> None:
    with open(spec_path) as f:
        spec = json.load(f)
    mesh.init_process_group("gloo", f"tcp://localhost:{spec['port']}",
                            spec["world"], r,
                            timeout=spec.get("timeout", 120))
    inp = torch.load(os.path.join(spec["dir"], "inputs.pt"),
                     weights_only=False)
    out = {}
    try:
        for case in spec["cases"]:
            kind, _, arg = case.partition(":")
            if kind != "cli":  # the CLI builds its own groups
                mesh.init_model_parallel(
                    spec["case_model"].get(case, spec["model"]))
            out[case] = CASES[kind](inp, arg)
    finally:
        mesh.destroy_process_group()
    torch.save(out, os.path.join(spec["dir"], f"out_{r}.pt"))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
