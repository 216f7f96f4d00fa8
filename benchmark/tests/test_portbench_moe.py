"""The Moonlight narrator's cell at MINI sizes on the CPU: the plain
reference against the port (teacher forced, with its own routing and
with the program's), the configuration against the zoo's model at full
size on the meta device, the roofline counts of the expert layer, a
sound run correct, the fp8 control and each planted fault of the expert
layer (``portbench/moe_faults.py``) not."""

import json

import pytest
import torch

from benchmark.portbench import faults, files, harness, moe_faults, weights
from benchmark.portbench import traffic as T
from benchmark.reference import moonlight as M
from benchmark.reference.numerics import Numerics
from benchmark.roofline import expert, moonlight_flops
from benchmark.tests import mini

MINI_MOE = "VCLM_OPENAI_TIMESFORMER_MINI_MOONLIGHT_MINI"
CELL = "mini-narrate-moe"
# the sizes of the zoo's MINI Moonlight narrator
MOE_CFG = {
    "model": MINI_MOE, "source": "test", "reduced": [], "dtype": "bfloat16",
    "gated_xattn": True,
    "vocab_size": 1024, "hidden_size": 256, "intermediate_size": 512,
    "moe_intermediate_size": 128, "num_hidden_layers": 3,
    "num_attention_heads": 4, "kv_lora_rank": 64, "qk_nope_head_dim": 32,
    "qk_rope_head_dim": 16, "v_head_dim": 32, "n_routed_experts": 8,
    "n_shared_experts": 2, "num_experts_per_tok": 3,
    "first_k_dense_replace": 1, "routed_scaling_factor": 2.446,
    "rms_norm_eps": 1e-05, "kv_norm_eps": 1e-06, "rope_theta": 50000,
    "tower": {**mini.TOWER, "img_size": 64, "num_frames": 2},
    "pooler": {"num_queries": 16, "heads": 4, "dim_head": 16},
    "cross": {"freq": 2, "heads": 4, "eps": 1e-05},
    "scalars": {"alpha_cattn": 0.5, "alpha_dense": 0.5}}
# the token embedding at unit RMS (256^-1/2 × 16), as the full-size cell
# scales its own (``narrate_moe.EMBED_SCALE``)
EMBED_SCALE = 16.0
TRAFFIC = {"batch": 3, "frames": 2, "pool": 2,
           "sampling": {"num_return_sequences": 2, "temperature": 0.7,
                        "top_p": 0.95, "top_k": 0, "max_text_length": 24,
                        "bos_id": 1000, "eos_id": 1001, "pad_id": 0}}
# every row of a batch kept: 138 tokens a unit, enough that draw_ks of a
# one-unit window (a slow host) stays well inside its limit
CHECK = {"rows_per_batch": 6,
         "limits": {"logit_err": 0.06, "route_gap": 0.01,
                    "nucleus_excess": 0.015, "draw_ks": 0.2}}
SECONDS = 1.5


@pytest.fixture
def moe_root(tmp_path, monkeypatch):
    from benchmark.drivers import narrate_moe
    monkeypatch.setattr(narrate_moe, "EMBED_SCALE", EMBED_SCALE)
    root = mini.make_root(tmp_path)
    b = root / "benchmark"
    (b / "configs" / "mini-moe.json").write_text(json.dumps(MOE_CFG))
    (b / "traffic" / f"{CELL}.json").write_text(json.dumps(TRAFFIC))
    (b / "workloads" / f"{CELL}.json").write_text(json.dumps({
        "config": "mini-moe", "traffic": CELL, "chips": 1,
        "driver": "narrate_moe", "why": "test", "check": CHECK}))
    bench = files.benchmark_json(root)
    bench["configs"].append({"name": "mini-moe", "source": "test",
                             "file": "benchmark/configs/mini-moe.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "mini-moe",
                               "traffic": CELL, "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if (m.get("moves", m["name"]) == "narrations_per_s"
                and "workloads" in m and (m["name"] == "narrations_per_s"
                                          or "narrate_moe" in m["name"]
                                          or m["name"] == "expert_roofline")):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def fan_in_experts(monkeypatch):
    """The stacked experts drawn at std fan_in^-1/2, as the full-size
    cell's 0.02 is within 20 % of (2048^-1/2 = 0.022 and 1408^-1/2 =
    0.027); at MINI widths 0.02 would leave the routed experts a few
    percent of the residual stream, below what a logit check can see."""
    rule = weights.rule

    def fan_in(name, shape, scalars):
        if len(shape) == 3 and "experts" in name:
            return 0.0, shape[2] ** -0.5
        return rule(name, shape, scalars)

    monkeypatch.setattr(weights, "rule", fan_in)


def _run(root, seed=2 ** 31 + 91, trace=False, control=False):
    return harness.run_cell(CELL, seed, SECONDS, trace, "cpu", root,
                            control=control)


def _model_and_weights(seed=3):
    from lavila_tpu_torch.models import build_model
    model = build_model(MINI_MOE, device="cpu", gated_xattn=True,
                        num_frames=MOE_CFG["tower"]["num_frames"])
    p = weights.draw(M.narrator_spec(MOE_CFG), seed, "cpu", torch.float32,
                     MOE_CFG["scalars"])
    weights.load(model, p)
    return model, {k: v.clone() for k, v in p.items()}


def test_reference_against_the_port():
    """fp32 on both sides: the teacher-forced logits agree to rounding
    (2e-4: 3 layers of fp32 products in another order), the program's
    routing is the reference's (route gap below 0), and a reference
    routed as the program routed gives the same logits."""
    from lavila_tpu_torch.models import moonlight
    model, p = _model_and_weights()
    frames = T.clips(TRAFFIC, MOE_CFG["tower"], 3, "cpu", torch.float32)[0]
    ids = torch.randint(0, 1000, (3, 9), generator=torch.Generator()
                        .manual_seed(0))
    chosen = []
    hooks = [m.register_forward_hook(lambda m, a, out: chosen.append(out[1]))
             for m in model.modules() if isinstance(m, moonlight.Router)]
    try:
        with torch.no_grad():
            got = model(frames, torch.cat([ids, ids[:, :1]], 1))["logits"]
    finally:
        for h in hooks:
            h.remove()
    num = Numerics("fp32")
    ref, gap = M.narrator_logits(p, frames, ids, MOE_CFG, num)
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)
    assert gap < 0
    routes = {1 + m: c.view(3, 9, -1) for m, c in enumerate(chosen)}
    forced, forced_gap = M.narrator_logits(p, frames, ids, MOE_CFG, num,
                                           routes)
    torch.testing.assert_close(forced, ref, rtol=1e-6, atol=1e-6)
    assert forced_gap == gap


def test_reference_fills_a_short_route():
    """Routes of one expert fewer are filled up by the reference's own
    ranking, so the reference still sums k experts a token."""
    _, p = _model_and_weights()
    p = {k[len("text_decoder."):]: v for k, v in p.items()}
    b, x, num = "model.layers.1.mlp.", torch.randn(5, 256), Numerics("fp32")
    full, gap = M.expert_layer(p, b, x, MOE_CFG, num)
    own = torch.topk(torch.sigmoid(x @ p[b + "gate.weight"].T)
                     + p[b + "gate.e_score_correction_bias"], 3,
                     dim=-1).indices
    filled, _ = M.expert_layer(p, b, x, MOE_CFG, num, own[:, :2])
    torch.testing.assert_close(filled, full)
    assert gap < 0


def test_full_config_is_the_ports_model():
    """The reference's parameters from the configuration file are the zoo
    model's, by name and shape, on the meta device; its language model
    counts 15.96 B parameters."""
    from lavila_tpu_torch.models import zoo
    bench = files.benchmark_json()
    cfg = files.config("narrator-tsfl336-moonlight16b", bench)
    with torch.device("meta"):
        model = zoo._REGISTRY[cfg["model"]](
            num_frames=cfg["tower"]["num_frames"], gated_xattn=True)
    port = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert port == {n: tuple(s) for n, s in M.narrator_spec(cfg)}
    for n, s in M.narrator_spec(cfg):
        weights.rule(n, s, cfg["scalars"])
    lm = sum(p.numel() for n, p in model.text_decoder.named_parameters()
             if "cross" not in n and "alpha" not in n)
    assert round(lm / 1e9, 2) == 15.96


def test_expert_roofline_counts():
    """The grouped products' bytes and operations by hand: 4 tokens, 2
    of 4 experts each (experts 0 and 1 only), 1 shared, D 128, I 64."""
    nbytes, flops = expert.layer_cost(4, 2, 1, 128, 64, 2, 2)
    N = 4 * 2 + 4
    assert nbytes == (3 * 3 * 64 * 128 + 2 * N * (128 + 64)) * 2
    assert flops == 2 * N * 3 * 64 * 128


def test_expert_roofline_used_experts_from_the_counters():
    """Two calls of 4 tokens × 2 experts on layer 1 (2, then 3 experts
    with a row): 2.5 a call; a layer without its rows counter is
    skipped."""
    counters = {"moe.rows.1": torch.tensor([6, 5, 5, 0]),
                "moe.used.1": torch.tensor(5),
                "moe.used.2": torch.tensor(4)}
    assert expert.used_per_call(counters, 4, 2) == [2.5]
    assert expert.used_per_call({}, 4, 2) == []


def test_model_flops_of_a_step():
    cfg = files.config("narrator-tsfl336-moonlight16b",
                       files.benchmark_json())
    # the active products a token at position 0: ~2 x 3.0 B
    assert 5.5e9 < moonlight_flops.decode_row_step(cfg, 0) < 6.5e9


def test_sound_run_correct(moe_root, fan_in_experts):
    result, _ = _run(moe_root)
    assert result["correct"], result["checks"]


def test_traced_run_reads_its_metrics(moe_root):
    """On the CPU the device readers read nothing; the counter does."""
    result, _ = _run(moe_root, trace=True)
    assert result["correct"]
    load = result["metrics"]["expert_load.narrate_moe"]["value"]
    assert 1.0 <= load <= 8.0 / 3
    assert "mfu.narrate_moe" in result["metrics"]


def test_control_fails_a_limit(moe_root):
    result, extra = _run(moe_root, control=True)
    assert result["correct"]
    fp8 = extra["control"]["fp8"]
    assert fp8["logit_err"] > result["checks"]["logit_err"]["limit"]


@pytest.mark.parametrize("fault,number", [
    ("bias_ignored", "route_gap"), ("scale_dropped", "logit_err"),
    ("one_expert_fewer", "logit_err")])
def test_expert_fault(moe_root, fan_in_experts, fault, number):
    moe_faults.register()
    with faults.planted(fault):
        result, _ = _run(moe_root)
    assert not result["correct"]
    c = result["checks"][number]
    assert c["value"] > c["limit"]


def test_faults_undo():
    from lavila_tpu_torch.models import moonlight
    before = moonlight.route
    moe_faults.register()
    for name in moe_faults.FAULTS:
        with faults.planted(name):
            assert moonlight.route is not before
    assert moonlight.route is before
