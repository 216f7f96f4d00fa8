"""One rank of the port's data-parallel CPU tests (gloo).

    python tests/torch_dist_worker.py SPEC_JSON RANK

``SPEC_JSON`` names the world size, the rendezvous port, the directory
holding ``inputs.pt`` (the global arrays, written by the test) and the
cases to run; the rank writes ``out_{RANK}.pt``. It imports only torch
and the port, so that each rank starts in seconds.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from lavila_tpu_torch import losses as L  # noqa: E402
from lavila_tpu_torch.models import build_model  # noqa: E402
from lavila_tpu_torch.models.dual_encoder import \
    VideoClassifierMultiHead  # noqa: E402
from lavila_tpu_torch.parallel import mesh  # noqa: E402
from lavila_tpu_torch.train import freeze as F  # noqa: E402
from lavila_tpu_torch.train import optim as O  # noqa: E402
from lavila_tpu_torch.train import step as S  # noqa: E402

torch.set_num_threads(1)


def rows(a, r, w):
    """Rank ``r``'s rows of the global array ``a`` (``w`` ranks)."""
    t = torch.as_tensor(np.asarray(a))
    b = t.shape[0] // w
    return t[r * b:(r + 1) * b]


def leaf(a):
    return a.clone().requires_grad_()


def loss_case(name, inp, r, w):
    """A loss on this rank's rows: its metrics and the gradients of its
    loss with respect to each differentiable input."""
    img, txt = leaf(rows(inp["img"], r, w)), leaf(rows(inp["txt"], r, w))
    scale = leaf(torch.tensor(inp["scale"]))
    pscale = leaf(torch.tensor(inp["pscale"]))
    ind = rows(inp["ind"], r, w)
    if name == "caption":
        leaves = [leaf(rows(inp["logits"], r, w))]
        m = L.caption_loss(leaves[0], rows(inp["labels"], r, w))
    elif name in ("clip", "clip_local"):
        leaves = [img, txt, scale]
        fn = L.clip_loss_local if name == "clip_local" else L.clip_loss
        m = fn(img, txt, scale)
    elif name in ("ssl", "ssl_local"):
        leaves = [img, txt, scale, pscale]
        fn = (L.ssl_clip_loss_local if name == "ssl_local"
              else L.ssl_clip_loss)
        m = fn(img, txt, scale, pscale, ind)
    else:  # max_margin, max_margin_adaptive
        leaves = [img, txt]
        weights = (rows(inp["weights"], r, w)
                   if name == "max_margin_adaptive" else None)
        m = L.max_margin_loss(img, txt, margin=0.2, weights=weights)
    grads = torch.autograd.grad(m["loss"], leaves)
    return {"metrics": {k: v.item() for k, v in m.items()},
            "grads": [g.numpy() for g in grads]}


def without_momentum(opt):
    """``opt`` (``use_sgd``) as plain SGD, the JAX side's
    ``make_optimizer(momentum=0.0)``: the update stays linear in the
    gradients."""
    for group in opt.inner.param_groups:
        group["momentum"] = 0.0
    return opt


def step_case(name, inp, r, w):
    """Two train steps of MINI (SGD without momentum) on this rank's
    rows of two global batches, from rank 0's weights (rank 1 starts
    from perturbed ones, which the broadcast replaces). Returns the
    per-step metrics and the final fp32 masters."""
    cfg = inp["steps"][name]
    caption = cfg["model"].startswith("VCLM")
    kw = {"gated_xattn": True} if caption else {}
    if cfg.get("heads"):  # a classifier over the dual encoder's tower
        model = VideoClassifierMultiHead(
            build_model(cfg["model"], device="cpu").visual, cfg["heads"],
            0.0).train()
    else:
        model = build_model(cfg["model"], device="cpu", train=True, **kw)
    model.load_state_dict(inp["state_dicts"][cfg.get("weights",
                                                     cfg["model"])],
                          strict=True)
    if r > 0:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    frozen = F.build_freeze_predicate(**cfg.get("freeze", {}))
    criterion = ({"logit_scale_pseudo": float(inp["log_pseudo"])}
                 if cfg.get("ssl") else None)
    state = S.TrainState.create(model, lambda p: without_momentum(
        O.make_optimizer(F.freeze_by_predicate(p, frozen), 1e-2,
                         weight_decay=0.0, use_sgd=True,
                         clip_grad_value=cfg.get("clip"),
                         update_freq=cfg.get("update_freq", 1))),
        dtype=torch.float32, criterion=criterion)
    mesh.broadcast_params(state)
    if caption:
        step = S.make_caption_train_step(pad_id=0)
    elif cfg.get("heads"):
        step = S.make_classifier_train_step(multihead=True,
                                            label_smoothing=0.1)
    elif cfg.get("retrieval"):
        step = S.make_retrieval_train_step("adaptive_max_margin",
                                           margin=0.4)
    else:
        step = S.make_clip_train_step(norm_embed=True,
                                      use_ssl=cfg.get("ssl", False),
                                      local_loss=cfg.get("local", False))
    metrics = []
    for batch in inp["batches"][cfg["batches"]]:
        local = {k: rows(v, r, w) for k, v in batch.items()
                 if k != "labels"}
        if "text" in local:
            local["text"] = local["text"].long()
        if "labels" in batch:  # (heads, B): the verb, noun, action ids
            local["labels"] = tuple(
                torch.as_tensor(lab).long()[r * len(lab) // w:
                                            (r + 1) * len(lab) // w]
                for lab in batch["labels"])
        state, m = step(state, local)
        metrics.append({k: v.item() for k, v in m.items()})
    return {"metrics": metrics,
            "params": {k: p.detach().numpy().copy()
                       for k, p in {**state.params,
                                    **state.criterion}.items()},
            "frozen": sorted(state.frozen)}


def primitives_case(inp, r, w):
    """``all_gather``'s forward and backward, ``all_reduce``'s,
    ``average_grads`` over several buckets, and ``broadcast_params`` of
    a state whose masters and AdamW moments differ by rank."""
    x = leaf(torch.arange(6.0).reshape(3, 2) + 10 * r)
    g = mesh.all_gather(x)
    (gx,) = torch.autograd.grad((g * (torch.arange(g.numel()).reshape(
        g.shape) + 1)).sum(), [x])
    y = leaf(torch.tensor([float(r + 1)]))
    (gy,) = torch.autograd.grad(mesh.all_reduce(y).sum() * (r + 1), [y])
    old = mesh.BUCKET_BYTES
    mesh.BUCKET_BYTES = 64  # several buckets
    try:
        grads = [torch.full((5,), float(r)), torch.full((3, 4), 2.0 * r),
                 torch.full((40,), float(r * r))]
        mesh.average_grads(grads)
    finally:
        mesh.BUCKET_BYTES = old
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        for p in lin.parameters():
            p.fill_(float(r))
    st = S.TrainState.create(lin, lambda p: O.make_optimizer(p, 0.1),
                             dtype=torch.float32)
    for p in st.params.values():
        p.grad = torch.full_like(p, float(r + 1))
    st.optimizer.step()  # the moments differ by rank
    mesh.broadcast_params(st)
    return {"gathered": g.detach().numpy(), "gather_grad": gx.numpy(),
            "reduce_grad": gy.numpy(),
            "averaged": [t.numpy() for t in grads],
            "broadcast": {"params": [p.detach().numpy().copy()
                                     for p in st.params.values()],
                          "moments": [t.numpy().copy() for t in
                                      mesh._optimizer_tensors(st.optimizer)]}}


def main(spec_path: str, r: int) -> None:
    with open(spec_path) as f:
        spec = json.load(f)
    w = spec["world"]
    mesh.init_process_group("gloo", f"tcp://localhost:{spec['port']}", w, r,
                            timeout=spec.get("timeout", 120))
    inp = torch.load(os.path.join(spec["dir"], "inputs.pt"),
                     weights_only=False)
    out = {}
    try:
        for case in spec["cases"]:
            kind, name = case.split(":")
            if kind == "loss":
                out[case] = loss_case(name, inp, r, w)
            elif kind == "step":
                out[case] = step_case(name, inp, r, w)
            else:
                out[case] = primitives_case(inp, r, w)
    finally:
        mesh.destroy_process_group()
    torch.save(out, os.path.join(spec["dir"], f"out_{r}.pt"))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
