"""The port's beam decoders (``models/beam.py``) against ``lavila_tpu``'s
``BeamDecoder`` on the CPU: the MINI narrator on the same weights (gates
non-zero, GPT-2's final-norm bias tilted towards EOS so that beams
finish before the length limit) and the same image tokens. Beam search
and group beam search are deterministic: the same tokens and scores
within 1e-4. Beam sample draws its candidates from the same numpy
seed, held by equality. One beam is greedy decoding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu.models.beam import BeamDecoder as JaxBeamDecoder
from lavila_tpu_torch.models.beam import BeamDecoder
from test_torch_caption import BOS, EOS, _jax_params, _port_model

torch.set_num_threads(1)

L = 12
SCALE, TILT = 30.0, 26.0


@pytest.fixture(scope="module")
def narrator():
    """(JAX decoder, port decoder, image tokens (2 clips) as numpy)."""
    jm, params = _jax_params(seed=4)
    # the logits scaled by SCALE through ln_f's γ (std ~0.16 → ~4.8), so
    # that they are peaked as a trained narrator's are, not near uniform
    # over 50257 tokens; EOS's raised by TILT through ln_f's β, to the
    # top for some rows and steps (the largest is ~4 std)
    ln_f = params["text_decoder"]["ln_f"]
    e = params["text_decoder"]["wte"]["embedding"][EOS]
    ln_f["scale"] = np.full_like(ln_f["scale"], SCALE)
    ln_f["bias"] = (TILT * e / (e @ e)).astype(np.float32)
    frames = np.random.default_rng(5).normal(size=(2, 4, 64, 64, 3)).astype(
        np.float32)
    tokens = np.array(jm.apply({"params": params}, jnp.asarray(frames),
                                 method="encode_image"))
    jdec = JaxBeamDecoder(jm, {"params": params}, bos_id=BOS, eos_id=EOS,
                          max_text_length=L)
    model = _port_model(params).eval()
    return jdec, BeamDecoder(model, bos_id=BOS, eos_id=EOS,
                             max_text_length=L), tokens


def _same(got, want):
    (ids, scores), (wids, wscores) = got, want
    np.testing.assert_array_equal(ids, np.asarray(wids))
    np.testing.assert_allclose(scores, np.asarray(wscores), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("num_beams,nrs,length_penalty",
                         [(3, 1, 1.0), (4, 2, 0.7), (5, 3, 1.5)])
def test_beam_search_matches_jax(narrator, num_beams, nrs, length_penalty):
    jdec, dec, tokens = narrator
    kw = dict(num_beams=num_beams, num_return_sequences=nrs,
              length_penalty=length_penalty)
    got = dec.beam_search(torch.from_numpy(tokens), **kw)
    _same(got, jdec.beam_search(jnp.asarray(tokens), **kw))
    assert got[0].shape == (2 * nrs, L) and (got[0][:, 0] == BOS).all()


def test_beams_finish_on_eos(narrator):
    """The tilted EOS ends a returned hypothesis before the length limit
    while another runs to it: both ways into a sample's pool are
    exercised."""
    _, dec, tokens = narrator
    ids, _ = dec.beam_search(torch.from_numpy(tokens), num_beams=4,
                             num_return_sequences=2)
    ended = (ids[:, 1:] == EOS).any(1)
    assert ended.any() and not ended.all()


@pytest.mark.parametrize("num_beams,groups,nrs,warp", [
    (6, 3, 1, {}),
    (4, 2, 2, {}),
    (6, 3, 2, {"temperature": 0.7, "top_p": 0.95}),
    (6, 2, 1, {"top_k": 5}),
])
def test_group_beam_search_matches_jax(narrator, num_beams, groups, nrs,
                                       warp):
    jdec, dec, tokens = narrator
    kw = dict(num_beams=num_beams, num_beam_groups=groups,
              num_return_sequences=nrs, **warp)
    _same(dec.group_beam_search(torch.from_numpy(tokens), **kw),
          jdec.group_beam_search(jnp.asarray(tokens), **kw))


@pytest.mark.parametrize("nrs,warp", [
    (1, {}),
    (2, {"temperature": 0.7, "top_p": 0.95}),
    (1, {"top_k": 20}),
])
def test_beam_sample_matches_jax_on_the_same_seed(narrator, nrs, warp):
    """Candidates drawn by ``np.random.Generator(seed)`` from the same
    warped distribution: the same draws, so the same tokens."""
    jdec, dec, tokens = narrator
    kw = dict(num_beams=3, num_return_sequences=nrs, **warp)
    got = dec.beam_sample(torch.from_numpy(tokens),
                          rng=np.random.default_rng(9), **kw)
    _same(got, jdec.beam_sample(jnp.asarray(tokens),
                                rng=np.random.default_rng(9), **kw))
    assert got[0].shape == (2 * nrs, L)


def test_group_beam_needs_groups_dividing_beams(narrator):
    _, dec, tokens = narrator
    with pytest.raises(ValueError, match="divide"):
        dec.group_beam_search(torch.from_numpy(tokens), num_beams=5,
                              num_beam_groups=3)


def test_one_beam_is_greedy(narrator):
    """``beam_search`` with one beam follows the argmax at every step:
    the greedy ``generate`` (top-k 1) up to each row's first EOS, after
    which the beam's row is padding."""
    _, dec, tokens = narrator
    toks = torch.from_numpy(tokens)
    ids, _ = dec.beam_search(toks, num_beams=1)
    with torch.inference_mode():
        greedy, _ = dec.model.generate(toks, generator=None, bos_id=BOS,
                                       eos_id=EOS, max_text_length=L,
                                       top_k=1)
    greedy = greedy.numpy()
    for row, want in zip(ids, greedy):
        hit = np.flatnonzero(want[1:] == EOS)
        end = hit[0] + 2 if hit.size else L
        np.testing.assert_array_equal(row[:end], want[:end])
        assert (row[end:] == 0).all()
