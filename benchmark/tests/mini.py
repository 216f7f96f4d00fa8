"""A copy of the benchmark with MINI cells, for the CPU tests: a tiny
DistilBERT dual encoder and the MINI narrator registered in the port's
zoo, their configuration files, traffic and cells beside the real ones
in a temporary checkout root (the real files are not touched)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark.portbench import files

MINI_DUAL = "BENCH_MINI_DISTILBERT"
MINI_NARRATOR = "VCLM_OPENAI_TIMESFORMER_MINI_GPT2_MINI"

TOWER = {"img_size": 32, "patch_size": 16, "embed_dim": 64, "depth": 2,
         "num_heads": 4, "num_frames": 2, "ln_pre": True}
TEXT = {"vocab_size": 1000, "dim": 64, "n_heads": 4, "hidden_dim": 128,
        "n_layers": 2, "max_position_embeddings": 80}
DUAL_CFG = {
    "model": MINI_DUAL, "source": "test", "reduced": [], "dtype": "bfloat16",
    "master_dtype": "float32", "remat": True, "remat_policy": "full",
    "norm_embed": True, "project_embed_dim": 32, "tower": TOWER,
    "text": TEXT, "scalars": {"logit_scale": 2.659260036932778},
    "optimizer": {"lr": 3e-05, "weight_decay": 0.01, "betas": [0.9, 0.999],
                  "eps": 1e-08}}
NARRATOR_CFG = {
    "model": MINI_NARRATOR, "source": "test", "reduced": [],
    "dtype": "bfloat16", "gated_xattn": True,
    "tower": {**TOWER, "img_size": 64, "num_frames": 2},
    "pooler": {"num_queries": 16, "heads": 4, "dim_head": 16},
    "gpt2": {"vocab_size": 50257, "n_positions": 128, "n_embd": 64,
             "n_layer": 2, "n_head": 4, "layer_norm_epsilon": 1e-05,
             "cross_attn_freq": 1},
    "scalars": {"alpha_cattn": 0.5, "alpha_dense": 0.5}}
TRAFFIC = {
    "mini-train": {"batch": 4, "frames": 2, "pool": 5, "captions": {
        "text_len": 12, "median": 5, "sigma": 0.5, "min": 3, "max": 10,
        "vocab_low": 200, "vocab_high": 1000, "cls_id": 101, "sep_id": 102,
        "pad_id": 0}},
    "mini-encode": {"batch": 3, "frames": 2, "pool": 2, "warmup": 1},
    "mini-narrate": {"batch": 4, "frames": 2, "pool": 2,
                     "sampling": {"num_return_sequences": 2,
                                  "temperature": 0.7, "top_p": 0.95,
                                  "top_k": 0, "max_text_length": 16,
                                  "bos_id": 50256, "eos_id": 50256,
                                  "pad_id": 0}}}
CELLS = {
    "mini-train": ("mini-dual", "train", {
        "steps": 3, "window_steps": 2, "limits": {"loss_gap": 0.03, "grad_gap": 0.06,
                               "change_gap": 0.05}}),
    "mini-encode": ("mini-dual", "encode", {"limits": {"embed_err": 0.05}}),
    "mini-narrate": ("mini-narrator", "narrate", {
        "rows_per_batch": 8,
        "limits": {"logit_err": 0.05, "nucleus_excess": 0.015,
                   "draw_ks": 0.12}})}

# windows long enough for a few units (the train cell compares its
# window's first two)
SECONDS = {"mini-train": 1.0, "mini-encode": 0.5, "mini-narrate": 2.0}


def register() -> None:
    """The tiny DistilBERT dual encoder in the port's zoo."""
    from lavila_tpu_torch.models import zoo
    from lavila_tpu_torch.models.distilbert import DistilBertModel
    from lavila_tpu_torch.models.dual_encoder import VideoCLIPHF
    from lavila_tpu_torch.models.timesformer import SpaceTimeTransformer
    if MINI_DUAL in zoo.available_models():
        return

    def BENCH_MINI_DISTILBERT(num_frames=2, remat=False,
                              remat_policy="full"):
        t = {k: v for k, v in TOWER.items() if k not in ("ln_pre",
                                                           "num_frames")}
        vision = SpaceTimeTransformer(num_frames=num_frames, remat=remat,
                                      remat_policy=remat_policy, **t)
        text = DistilBertModel(TEXT["vocab_size"], TEXT["dim"],
                               TEXT["n_heads"], TEXT["hidden_dim"],
                               TEXT["n_layers"],
                               TEXT["max_position_embeddings"])
        return VideoCLIPHF(vision, text, DUAL_CFG["project_embed_dim"])

    zoo.register(BENCH_MINI_DISTILBERT)


def make_root(tmp: Path) -> Path:
    """A checkout root holding the benchmark and the MINI cells."""
    register()
    shutil.copytree(files.bench_dir(), tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = files.benchmark_json()
    b = tmp / "benchmark"
    for name, cfg in (("mini-dual", DUAL_CFG),
                      ("mini-narrator", NARRATOR_CFG)):
        path = f"benchmark/configs/{name}.json"
        (tmp / path).write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": path, "reduced": [], "why": "test"})
    for name, t in TRAFFIC.items():
        (b / "traffic" / f"{name}.json").write_text(json.dumps(t))
    e2e = {"train": ["train_clips_per_s"],
           "encode": ["encode_clips_per_s", "encode_ms_p95"],
           "narrate": ["narrations_per_s"]}
    for cell, (cfg, driver, check) in CELLS.items():
        (b / "workloads" / f"{cell}.json").write_text(json.dumps({
            "config": cfg, "traffic": cell, "chips": 1, "driver": driver,
            "why": "test", "check": check}))
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": cell, "chips": 1,
                                   "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m.get("moves", m["name"]) in e2e[driver] and "workloads" in m:
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp
