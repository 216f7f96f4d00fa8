"""The plain reference against the port at the MINI sizes on the CPU,
both in float32 on the same weights (drawn by ``portbench.weights``)
and inputs (``portbench.traffic``): the dual encoder's embeddings, the
CLIP loss, one AdamW step of the masters, and the narrator's logits,
teacher forced and through the cached greedy decode."""

import pytest
import torch

from benchmark.portbench import traffic as T
from benchmark.portbench import weights as W
from benchmark.reference import models as R
from benchmark.reference.numerics import Numerics
from benchmark.tests import mini

NUM = Numerics("fp32")


def _dual(remat=False):
    from lavila_tpu_torch.models import build_model
    mini.register()
    cfg = mini.DUAL_CFG
    model = build_model(cfg["model"], device="cpu", train=True,
                        num_frames=cfg["tower"]["num_frames"], remat=remat)
    p = W.draw(R.dual_encoder_spec(cfg), 5, "cpu", torch.float32,
               cfg["scalars"])
    W.load(model, p)
    t = mini.TRAFFIC["mini-train"]
    frames = T.clips(t, cfg["tower"], 5, "cpu", torch.float32)[0]
    ids, mask = (x[0] for x in T.captions(t, 5, "cpu"))
    return cfg, model, {k: v.clone() for k, v in p.items()}, \
        {"frames": frames, "text": ids, "mask": mask}


def test_dual_encoder_embeddings():
    cfg, model, p, b = _dual()
    model.eval()
    with torch.no_grad():
        img = model.encode_image(b["frames"])
        txt = model.encode_text(b["text"], b["mask"])
        torch.testing.assert_close(
            R.encode_image(p, b["frames"], cfg, NUM), img,
            rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(
            R.encode_text(p, b["text"], b["mask"], cfg, NUM), txt,
            rtol=1e-4, atol=1e-4)


def test_clip_loss_and_adamw_step():
    from lavila_tpu_torch.train.optim import make_optimizer
    from lavila_tpu_torch.train.step import TrainState, make_clip_train_step
    cfg, model, p, b = _dual(remat=True)
    opt = cfg["optimizer"]
    state = TrainState.create(model, lambda params: make_optimizer(
        params, opt["lr"], weight_decay=opt["weight_decay"]),
        dtype=torch.float32)
    step = make_clip_train_step(norm_embed=True)
    state, m = step(state, b)
    params = {k: v.requires_grad_(True) for k, v in p.items()}
    loss = R.clip_loss(params, b, cfg, NUM, remat=True)
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    assert float(m["loss"]) == pytest.approx(float(loss.detach()),
                                             rel=1e-5)
    adamw = R.AdamW(params, opt["lr"], opt["weight_decay"])
    adamw.step(params, grads)
    inner = state.optimizer.inner
    top = max(float(g.abs().max()) for g in grads.values())
    for name, master in state.params.items():
        g = grads[name]
        # the gradient AdamW took: its first moment after one step
        torch.testing.assert_close(inner.state[master]["exp_avg"] / 0.1, g,
                                   rtol=1e-3, atol=1e-6 * top, msg=name)
        # the update, where the gradient is not nought to rounding (there
        # AdamW's first step is the sign of round-off: the key biases)
        keep = g.abs() > max(1e-3 * float(g.abs().max()), 1e-5 * top)
        torch.testing.assert_close(master.detach()[keep],
                                   params[name].detach()[keep], rtol=0,
                                   atol=3e-7, msg=name)


def _narrator():
    from lavila_tpu_torch.models import build_model
    cfg = mini.NARRATOR_CFG
    model = build_model(cfg["model"], device="cpu", gated_xattn=True,
                        num_frames=cfg["tower"]["num_frames"])
    p = W.draw(R.narrator_spec(cfg), 9, "cpu", torch.float32, cfg["scalars"])
    W.load(model, p)
    t = mini.TRAFFIC["mini-narrate"]
    frames = T.clips(t, cfg["tower"], 9, "cpu", torch.float32)[0]
    return cfg, model, {k: v.clone() for k, v in p.items()}, frames


def test_narrator_teacher_forced_logits():
    cfg, model, p, frames = _narrator()
    ids = torch.randint(0, 50257, (frames.shape[0], 8),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model(frames, ids)["logits"]
        ref = R.narrator_logits(p, frames, ids[:, :-1], cfg, NUM)
    torch.testing.assert_close(ref, got, rtol=1e-4, atol=1e-4)


def test_narrator_cached_greedy_decode():
    """The cached decode's greedy tokens are the reference's argmax at
    every position of a full forward over them."""
    cfg, model, p, frames = _narrator()
    with torch.no_grad():
        ids, _ = model.generate(model.encode_image(frames), generator=None,
                                bos_id=50256, eos_id=50256,
                                max_text_length=8, top_k=1)
        ref = R.narrator_logits(p, frames, ids[:, :-1], cfg, NUM)
    assert torch.equal(ref.argmax(-1), ids[:, 1:])


@pytest.mark.parametrize("temperature,top_k", [(0.7, None), (1.0, 50)])
def test_sampler_placement_of_exact_draws(temperature, top_k):
    """Tokens drawn from the exact nucleus lie inside it, and their places
    are uniform; tokens drawn from the whole distribution are not."""
    from benchmark.reference import sampler
    gen = torch.Generator().manual_seed(7)
    n, V, p = 3000, 400, 0.9
    logits = torch.randn(n, V, generator=gen)
    probs = sampler.tempered(logits, temperature, top_k)
    desc, order = torch.sort(probs, dim=-1, descending=True)
    keep = ((desc.cumsum(-1) - desc) < p).float()
    nucleus = torch.zeros_like(probs).scatter(-1, order, keep) * probs
    served = torch.multinomial(nucleus, 1, generator=gen)[:, 0]
    excess, u = sampler.placement(logits, served,
                                  torch.rand(n, generator=gen), temperature,
                                  top_k, p)
    assert float(excess.max()) < 0
    assert sampler.ks_uniform(u) < 1.63 / n ** 0.5  # the 1% point
    wide = torch.multinomial(torch.softmax(logits, -1), 1, generator=gen)
    excess, u = sampler.placement(logits, wide[:, 0],
                                  torch.rand(n, generator=gen), temperature,
                                  top_k, p)
    assert float(excess.max()) > 0
    assert sampler.ks_uniform(u) > 3 * 1.63 / n ** 0.5


def test_attention_control_rounds_only_the_attention():
    from benchmark.reference.numerics import Numerics
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 3, 5, 8, generator=gen) for _ in range(3))
    x, w = torch.randn(4, 8, generator=gen), torch.randn(6, 8, generator=gen)
    exact, low = Numerics("fp32"), Numerics("fp8attn")
    assert torch.equal(exact.linear(x, w), low.linear(x, w))
    gap = (exact.attend(q, k, v) - low.attend(q, k, v)).abs().max()
    assert 0 < float(gap) < 0.2
    keep = torch.ones(5, 5, dtype=torch.bool).tril()
    assert torch.allclose(exact.attend(q, k, v, keep)[..., 0, :], v[..., 0, :])
