"""A run with the timed path broken underneath comes out not correct:
the harness driven on the CPU at the MINI sizes (its look for a card
skipped), with each fault a cell can have planted in the port. No cell
spans cards, so there is no exchange between chips to leave out."""

import pytest
import torch

from benchmark.portbench import faults, harness
from benchmark.tests.mini import SECONDS


def _run(root, cell):
    result, _ = harness.run_cell(cell, 2 ** 31 + 77, SECONDS[cell],
                                 False, "cpu", root)
    return result


def test_sound_runs_are_correct(mini_root):
    for cell in ("mini-train", "mini-encode", "mini-narrate"):
        assert _run(mini_root, cell)["correct"], cell


def test_train_state_unchanged(mini_root, monkeypatch):
    from lavila_tpu_torch.train import optim
    monkeypatch.setattr(optim.Optimizer, "step", lambda self: None)
    r = _run(mini_root, "mini-train")
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch(mini_root, monkeypatch):
    from lavila_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh, "all_gather",
                        lambda x, *a, **k: x[: x.shape[0] // 2])
    r = _run(mini_root, "mini-train")
    assert not r["correct"]
    assert r["checks"]["loss_gap"]["value"] > r["checks"]["loss_gap"][
        "limit"]


def test_encode_answer_altered(mini_root, monkeypatch):
    from lavila_tpu_torch.models.dual_encoder import VideoCLIPHF
    orig = VideoCLIPHF.encode_image

    def altered(self, image, generator=None):
        out = orig(self, image, generator)
        return torch.cat([out[:1] * 1.1, out[1:]])

    monkeypatch.setattr(VideoCLIPHF, "encode_image", altered)
    assert not _run(mini_root, "mini-encode")["correct"]


def test_encode_half_batch(mini_root, monkeypatch):
    from lavila_tpu_torch.models.dual_encoder import VideoCLIPHF
    orig = VideoCLIPHF.encode_image

    def half(self, image, generator=None):
        h = (image.shape[0] + 1) // 2
        out = orig(self, image[:h], generator)
        return torch.cat([out, out])[: image.shape[0]]

    monkeypatch.setattr(VideoCLIPHF, "encode_image", half)
    assert not _run(mini_root, "mini-encode")["correct"]


def test_narrate_token_altered(mini_root, monkeypatch):
    from lavila_tpu_torch.models import sampling
    orig = sampling.sample_token
    monkeypatch.setattr(sampling, "sample_token",
                        lambda g, logits: (orig(g, logits) + 1) % 50257)
    assert not _run(mini_root, "mini-narrate")["correct"]


def test_narrate_cache_left_stale(mini_root, monkeypatch):
    """A decode step that attends over none of its cache (the state a
    step should carry, left unchanged)."""
    from lavila_tpu_torch.models import gpt2
    orig = gpt2.decode_attention
    monkeypatch.setattr(gpt2, "decode_attention",
                        lambda q, kc, vc, kn, vn, nv, h: orig(
                            q, kc, vc, kn, vn, 0, h))
    assert not _run(mini_root, "mini-narrate")["correct"]


@pytest.mark.parametrize("fault,number", [
    ("top_p_ignored", "nucleus_excess"), ("temperature_1", "draw_ks"),
    ("other_row", "nucleus_excess")])
def test_narrate_sampler_fault(mini_root, fault, number):
    """The sampled draws are judged against the reference's sampling
    distribution: a nucleus not applied, the temperature left at 1, or a
    row's token drawn from another row's logits comes out not correct."""
    with faults.planted(fault):
        r = _run(mini_root, "mini-narrate")
    assert not r["correct"]
    c = r["checks"][number]
    assert c["value"] > c["limit"]


def test_faults_undo(mini_root):
    from lavila_tpu_torch.models import sampling
    before = (sampling.apply_top_p, sampling.apply_temperature,
              sampling.sample_token)
    for name in faults.FAULTS:
        with faults.planted(name):
            pass
    assert (sampling.apply_top_p, sampling.apply_temperature,
            sampling.sample_token) == before


def test_train_half_batch_after_warmup(mini_root, monkeypatch):
    """A step that changes its path once set-up is over (here: half the
    batch in the loss from the window's first step on) is caught by the
    window's own compared steps, though set-up's steps are sound."""
    from lavila_tpu_torch.parallel import mesh
    orig, calls = mesh.all_gather, []

    def gather(x, *a, **k):
        calls.append(1)
        # two gathers a step (image and text embeddings); 3 set-up steps
        return x[: x.shape[0] // 2] if len(calls) > 6 else orig(x, *a, **k)

    monkeypatch.setattr(mesh, "all_gather", gather)
    r = _run(mini_root, "mini-train")
    assert not r["correct"]
    assert r["checks"]["loss_gap"]["value"] > r["checks"]["loss_gap"][
        "limit"]
    assert r["checks"]["grad_gap"]["value"] < r["checks"]["grad_gap"][
        "limit"]
