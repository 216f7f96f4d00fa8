"""The port's copies of the framework-free ``lavila_tpu`` modules against
their originals, on the same numpy inputs: each case calls the same
function through both packages and asserts equal results (exactly: the
copies differ from the originals only in their import lines, and the
meters in their cross-process sync)."""

import numpy as np
import pytest

import lavila_tpu.config as jax_config
import lavila_tpu.data.datasets as jax_datasets
import lavila_tpu.data.label_maps as jax_label_maps
import lavila_tpu.data.sampling as jax_sampling
import lavila_tpu.data.tokenizers as jax_tokenizers
import lavila_tpu.data.transforms as jax_transforms
import lavila_tpu.eval.metrics as jax_metrics
import lavila_tpu.eval.nlg as jax_nlg
import lavila_tpu.utils.meters as jax_meters
import lavila_tpu.utils.random as jax_random
import lavila_tpu_torch.config as port_config
import lavila_tpu_torch.data.datasets as port_datasets
import lavila_tpu_torch.data.label_maps as port_label_maps
import lavila_tpu_torch.data.sampling as port_sampling
import lavila_tpu_torch.data.tokenizers as port_tokenizers
import lavila_tpu_torch.data.transforms as port_transforms
import lavila_tpu_torch.eval.metrics as port_metrics
import lavila_tpu_torch.eval.nlg as port_nlg
import lavila_tpu_torch.utils.meters as port_meters
import lavila_tpu_torch.utils.random as port_random

CAPTIONS = ["#C C opens the fridge", "a person slices a tomato!",
            "#O man X picks up 3 cups from the table."]


def _frames(seed=0, shape=(4, 72, 96, 3)):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(
        np.float32)


def _sim_rel(seed=1, n=12):
    rng = np.random.default_rng(seed)
    sim = rng.normal(size=(n, n)).astype(np.float32)
    rel = (rng.uniform(size=(n, n)) > 0.7).astype(np.float32)
    rel[np.arange(n), np.arange(n)] = 1.0
    return sim, rel


def _bpe(m):
    tok = m.ClipBpeTokenizer()
    return tok(CAPTIONS), [tok.encode(c) for c in CAPTIONS]


def _eval_transform(m):
    return [m.EvalTransform(64, *m.normalization_for_model("X_OPENAI_Y"))(
                _frames()),
            m.EvalTransform(48, num_spatial_crops=3)(_frames(2)),
            m.EvalTransform(32, num_spatial_crops=6, num_temporal_clips=2,
                            frames_per_clip=2)(_frames(3))]


def _train_transform(m):
    t = m.TrainTransform(64, seed=5, flip=True)
    return [t(_frames(4)), t(_frames(5))]


def _metrics(m):
    sim, rel = _sim_rel()
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(20, 7))
    targets = rng.integers(0, 7, 20)
    cm = m.confusion_matrix(logits.argmax(1), targets, 7)
    gts = (rng.uniform(size=(20, 7)) > 0.6).astype(np.float32)
    types = rng.integers(1, 3, 20)
    return [m.retrieval_map(sim, rel), m.retrieval_ndcg(sim, rel),
            m.topk_accuracy(logits, targets, ks=(1, 5)), cm,
            m.mean_class_accuracy(cm), m.multilabel_map(logits, gts),
            m.egomcq_accuracy(logits[:, :5], targets % 5, types)]


def _sampling(m):
    return [m.uniform_frame_ids(3, 95, 8, jitter=False),
            m.uniform_frame_ids(3, 95, 8, jitter=True,
                                rng=np.random.default_rng(7)),
            m.clip_window_frame_ids(10, 300, clip_length=4, clip_stride=16,
                                    num_clips=3),
            m.clip_window_frame_ids(10, 300, clip_length=4, clip_stride=8,
                                    jitter=True,
                                    rng=np.random.default_rng(8)),
            m.clip_window_frame_ids(0, 20, clip_length=4, clip_stride=16),
            m.clip_window_frame_ids(0, 200, clip_length=4, sparse=True,
                                    num_clips=2)]


def _config(m):
    cfg = m.parse_config(m.PretrainConfig, [
        "--model", "CLIP_OPENAI_TIMESFORMER_MINI", "--batch-size", "4",
        "--betas", "0.9", "0.95", "--clip-length", "8", "--steps", "3",
        "--lr", "1e-4", "--norm-embed"])
    return [cfg.asdict(), m.model_kwargs_from_config(cfg)]


def _synthetic(m):
    cfg = m.DatasetConfig(dataset="synthetic", root="", metadata="",
                          clip_length=4)
    ds = m.VideoCaptionDataset(cfg, lambda clip: clip[:, :8, :8],
                               tokenizer=None, is_training=False)
    return [len(ds)] + [ds[i] for i in (0, 1, 37)]


def _nlg(m):
    hyps = ["C opens the fridge door", "a person slices a tomato",
            "picks up 3 cups", ""]
    refs = [["#C C opens the fridge."], ["A person slices the tomato!",
                                         "someone cuts a tomato"],
            ["#O man X picks up 3 cups from the table."], ["empty"]]
    norm = [m.bert_style_normalize(h) for h in hyps]
    return [norm, m.nlg_scores(norm, refs), m.bleu(hyps, refs, max_n=2),
            m.meteor(hyps, refs, use_stem=False), m.rouge_l(hyps, refs),
            m.cider(hyps, refs)]


def _label_map(m):
    return m.actions_to_parts({"1:2": 0, "0:5": 1, "3:2": 2})


def _meters(m):
    meter = m.AverageMeter("loss", ":.3f")
    for v, n in ((1.5, 2), (0.25, 3), (4.0, 1)):
        meter.update(v, n)
    meter.synchronize()  # one process: a no-op in both
    return [meter.avg, meter.sum, meter.count, str(meter)]


def _random(m):
    m.random_seed(11, rank=2)
    return [np.random.uniform(size=3)]


CASES = {
    "tokenizers": (jax_tokenizers, port_tokenizers, _bpe),
    "eval_transform": (jax_transforms, port_transforms, _eval_transform),
    "train_transform": (jax_transforms, port_transforms, _train_transform),
    "metrics": (jax_metrics, port_metrics, _metrics),
    "sampling": (jax_sampling, port_sampling, _sampling),
    "config": (jax_config, port_config, _config),
    "synthetic_dataset": (jax_datasets, port_datasets, _synthetic),
    "label_maps": (jax_label_maps, port_label_maps, _label_map),
    "nlg": (jax_nlg, port_nlg, _nlg),
    "meters": (jax_meters, port_meters, _meters),
    "random": (jax_random, port_random, _random),
}


def _assert_same(a, b, path="result"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("case", sorted(CASES))
def test_copy_matches_original(case):
    original, copy, fn = CASES[case]
    assert copy is not original
    _assert_same(fn(original), fn(copy))


def test_assets_are_the_same_bytes():
    from pathlib import Path
    a = Path(jax_tokenizers.CLIP_BPE_PATH)
    b = Path(port_tokenizers.CLIP_BPE_PATH)
    assert b.parent.parent.name == "lavila_tpu_torch"
    assert a.read_bytes() == b.read_bytes()


def test_video_copy_loads_the_repo_native_library():
    import lavila_tpu.data.video as jax_video
    import lavila_tpu_torch.data.video as port_video
    assert port_video._LIB_PATH == jax_video._LIB_PATH
