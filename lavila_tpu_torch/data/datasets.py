"""Dataset metadata parsers and dataset classes.

Covers the six dataset families of the reference
(reference: lavila/data/datasets.py:105-517):
  ego4d (pkl narrations incl. pseudo-narration 5-tuples), ego4d_mcq (json),
  ek100_cls / ek100_mir (EPIC-Kitchens CSV + relevancy matrix), egtea,
  charades_ego (trimmed / untrimmed), charades_ego_trimmed (pkl) —
plus a ``synthetic`` family that fabricates clips on the fly so every
entry point runs without real data (no-network CI, benchmarks).

Outputs are numpy, channel-last (T, H, W, C); tokenization happens in the
dataset so the loader emits fixed-shape batches.
"""

from __future__ import annotations

import csv
import glob
import json
import os.path as osp
import pickle
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np

from lavila_tpu_torch.data import video as video_io
from lavila_tpu_torch.data.sampling import (clip_window_frame_ids,
                                            uniform_frame_ids)


def datetime2sec(ts: str) -> float:
    hh, mm, ss = ts.split(":")
    return int(hh) * 3600 + int(mm) * 60 + float(ss)


# --------------------------------------------------------------------------
# metadata parsing (one function per family, individually testable)
# --------------------------------------------------------------------------

def parse_ego4d_metadata(metadata: str) -> list:
    """pkl of (vid, t_start, t_end, narration[, narrator_nlls]) tuples."""
    with open(metadata, "rb") as f:
        return pickle.load(f)


def parse_ego4d_mcq_metadata(metadata: str) -> dict:
    with open(metadata) as f:
        return json.load(f)


def parse_ek100_metadata(root: str, metadata: str,
                         probe_fps: Callable[[str], float] = None) -> list:
    """EPIC-Kitchens CSV → (vid_path, start_frame, end_frame, narration,
    verb, noun); timestamps converted with each video's true fps."""
    probe_fps = probe_fps or (lambda p: video_io.probe_fps(p))
    fps_cache: dict[str, float] = {}
    samples = []
    with open(metadata) as f:
        reader = csv.reader(f)
        next(reader)  # header
        for row in reader:
            pid, vid = row[1], row[2]
            start_s, end_s = datetime2sec(row[4]), datetime2sec(row[5])
            narration = row[8]
            verb, noun = int(row[10]), int(row[12])
            vid_path = f"{pid}/{vid}.MP4"
            full = osp.join(root, vid_path)
            if full not in fps_cache:
                fps_cache[full] = probe_fps(full)
            fps = fps_cache[full]
            samples.append((vid_path, int(np.round(fps * start_s)),
                            int(np.ceil(fps * end_s)), narration, verb,
                            noun))
    return samples


class Ek100MirRelevancy(NamedTuple):
    """EK-100 MIR side files: the sentence csv (one row per UNIQUE
    narration, first column = narration id) and the (n_videos x
    n_sentences) graded relevancy matrix. ``sentence_ids`` drive the
    reference's column-selection protocol (eval_zeroshot.py:176-179):
    each sentence's similarity column is taken from the video row whose
    narration id matches."""
    sentence_ids: list
    sentences: list
    rel: np.ndarray


def load_ek100_video_ids(metadata: str) -> list:
    """First column (narration id) of each video row of the EK100 csv —
    the reference's ``pd.read_csv(metadata).values[:, 0]``
    (eval_zeroshot.py:176)."""
    with open(metadata) as f:
        reader = csv.reader(f)
        next(reader)
        return [row[0] for row in reader]


def load_ek100_mir_relevancy(metadata: str,
                             relevancy_path: str = None
                             ) -> Ek100MirRelevancy:
    """Sentence csv + relevancy pkl that sit next to the EK100 csv
    (reference datasets.py:136-144). ``relevancy_path`` overrides the
    derived pkl location (reference --relevancy-path,
    main_finetune_retrieval.py:54, used at :554)."""
    base = metadata[:metadata.index(".csv")]
    sentence_ids, sentences = [], []
    with open(base + "_sentence.csv") as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            sentence_ids.append(row[0])
            sentences.append(row[1])
    if not relevancy_path:
        base = osp.basename(metadata)
        if "train" in base:
            rel_name = "caption_relevancy_EPIC_100_retrieval_train.pkl"
        elif "test" in base:
            rel_name = "caption_relevancy_EPIC_100_retrieval_test.pkl"
        else:
            raise ValueError(f"{base} must contain 'train' or 'test'")
        relevancy_path = osp.join(osp.dirname(metadata), "relevancy",
                                  rel_name)
    with open(relevancy_path, "rb") as f:
        rel = pickle.load(f)
    return Ek100MirRelevancy(sentence_ids, sentences, np.asarray(rel))


def parse_egtea_metadata(root: str, metadata: str,
                         probe_len: Callable[[str], int] = None) -> list:
    probe_len = probe_len or (lambda p: video_io.probe_num_frames(p))
    act_map = {}
    with open(osp.join(osp.dirname(metadata), "action_idx.txt")) as f:
        for row in f:
            row = row.strip()
            if not row:
                continue
            parts = row.split(" ")
            act_map[int(parts[-1])] = " ".join(parts[:-1]).replace(
                "_", " ").lower()
    samples = []
    len_cache: dict[str, int] = {}
    with open(metadata) as f:
        for row in f:
            parts = row.strip().split(" ")
            if len(parts) < 2:
                continue
            clip_id, action_idx = parts[0], int(parts[1])
            video_id = "-".join(clip_id.split("-")[:3])
            rel = osp.join(video_id, f"{clip_id}.mp4")
            full = osp.join(root, rel)
            if full not in len_cache:
                len_cache[full] = probe_len(full)
            samples.append((rel, 0, len_cache[full], act_map[action_idx]))
    return samples


def parse_charades_ego_metadata(root: str, metadata: str, is_trimmed: bool,
                                probe_fps: Callable[[str], float] = None
                                ) -> list:
    probe_fps = probe_fps or (lambda p: video_io.probe_fps(p))
    fps_cache: dict[str, float] = {}
    samples = []
    with open(metadata) as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            video_id = row[0]
            vid_path = f"{video_id}.mp4"
            full = osp.join(root, vid_path)
            if full not in fps_cache:
                fps_cache[full] = probe_fps(full)
            fps = fps_cache[full]
            if is_trimmed:
                for action_tuple in row[9].split(";"):
                    if not action_tuple:
                        continue
                    action, t0, t1 = action_tuple.split(" ")
                    samples.append((vid_path,
                                    int(np.round(fps * float(t0))),
                                    int(np.ceil(fps * float(t1))), action))
            else:
                actions = ([a.split(" ")[0] for a in row[9].split(";")]
                           if row[9] else [])
                samples.append((vid_path, 0, fps * float(row[10]), actions))
    return samples


# --------------------------------------------------------------------------
# dataset classes
# --------------------------------------------------------------------------

@dataclass
class DatasetConfig:
    dataset: str
    root: str
    metadata: str
    clip_length: int = 32
    clip_stride: int = 2
    num_clips: int = 1
    sparse_sample: bool = False
    narration_selection: str = "random"
    is_trimmed: bool = True
    subsample_stride: Optional[int] = None
    # explicit EK-100 MIR relevancy pkl; None derives it from the
    # metadata dir (reference --relevancy-path)
    relevancy_path: Optional[str] = None


class VideoMetadataBase:
    """Shared metadata loading + per-family clip sampling."""

    def __init__(self, cfg: DatasetConfig, is_training: bool = True,
                 seed: Optional[int] = None):
        self.cfg = cfg
        self.dataset = cfg.dataset
        self.root = cfg.root
        self.is_training = is_training
        self.rng = np.random.default_rng(seed)
        self.relevancy_threshold = 0.1
        self.metadata_sentences = None
        self.relevancy_mat = None

        d = cfg.dataset
        if d == "ego4d":
            self.samples = parse_ego4d_metadata(cfg.metadata)
        elif d == "ego4d_mcq":
            self.samples = parse_ego4d_mcq_metadata(cfg.metadata)
        elif d in ("ek100_cls", "ek100_mir"):
            self.samples = parse_ek100_metadata(cfg.root, cfg.metadata)
            if d == "ek100_mir":
                mir = load_ek100_mir_relevancy(cfg.metadata,
                                               cfg.relevancy_path)
                self.metadata_sentences = mir.sentences
                self.relevancy_mat = mir.rel
        elif d == "egtea":
            self.samples = parse_egtea_metadata(cfg.root, cfg.metadata)
        elif d == "charades_ego":
            self.samples = parse_charades_ego_metadata(
                cfg.root, cfg.metadata, cfg.is_trimmed)
        elif d == "charades_ego_trimmed":
            with open(cfg.metadata, "rb") as f:
                self.samples = pickle.load(f)
        elif d == "synthetic":
            self.samples = [("synthetic", 0, 90, f"a synthetic clip {i}")
                            for i in range(256)]
        else:
            raise NotImplementedError(d)

        self.full_samples = list(self.samples)
        if cfg.subsample_stride:
            self.samples = self.samples[::cfg.subsample_stride]

    def __len__(self):
        return len(self.samples)

    # ---- clip loading per family -------------------------------------
    def _load_dense_or_sparse(self, vid_path, start, end):
        cfg = self.cfg
        ids = clip_window_frame_ids(
            int(start), int(end), clip_length=cfg.clip_length,
            clip_stride=cfg.clip_stride, num_clips=cfg.num_clips,
            sparse=cfg.sparse_sample, jitter=self.is_training, rng=self.rng)
        return video_io.video_loader_by_frames(self.root, vid_path, ids)

    def _select_narration(self, narration):
        if isinstance(narration, list):
            mode = self.cfg.narration_selection
            if mode == "random":
                return narration[int(self.rng.integers(len(narration)))]
            if mode == "concat":
                return ". ".join(narration)
            if mode == "list":
                return narration
            raise ValueError(mode)
        return narration

    def get_raw_item(self, i: int):
        cfg = self.cfg
        d = self.dataset
        if d == "synthetic":
            k = 16 + 3 * (i % 60)
            frames = np.full((cfg.clip_length, 64, 64, 3), k % 240,
                             np.float32)
            return frames, self.samples[i][3]
        if d == "ego4d":
            rec = self.samples[i]
            vid, start_s, end_s, narration = rec[:4]
            frames = video_io.video_loader(
                self.root, vid, start_s, end_second=end_s,
                clip_length=cfg.clip_length, jitter=self.is_training,
                rng=self.rng)
            return frames, self._select_narration(narration)
        if d == "ego4d_mcq":
            item = self.samples[str(i)]
            query = item["query"]["clip_text"]
            options, texts = [], []
            for oid in range(len(item["choices"])):
                opt = item["choices"][str(oid)]
                options.append(video_io.video_loader(
                    self.root, opt["video_uid"], float(opt["clip_start"]),
                    end_second=float(opt["clip_end"]),
                    clip_length=cfg.clip_length, jitter=self.is_training,
                    rng=self.rng))
                texts.append(opt["clip_text"])
            return query, options, texts, item["answer"], item["types"]
        if d == "ek100_mir":
            vid_path, start, end, narration, verb, noun = self.samples[i]
            # multi-clip eval: sample num_clips × clip_length frames
            # uniformly over the span; EvalTransform splits them into
            # temporal windows (reference eval_zeroshot.py:117-125 applies
            # TemporalCrop/SpatialCrop to the MIR val path too)
            n_seg = cfg.clip_length * (
                1 if self.is_training else max(cfg.num_clips, 1))
            ids = uniform_frame_ids(start, end, n_seg,
                                    jitter=self.is_training, rng=self.rng)
            frames = video_io.video_loader_by_frames(self.root, vid_path, ids)
            if self.is_training:
                pos = np.where(
                    self.relevancy_mat[i] > self.relevancy_threshold)[0]
                if len(pos):
                    j = int(self.rng.choice(pos))
                    if (j < len(self.metadata_sentences)
                            and j < self.relevancy_mat.shape[1]):
                        return frames, (self.metadata_sentences[j],
                                        float(self.relevancy_mat[i][j]))
            # narration_selection applies whenever the metadata carries
            # list-valued narrations (EPIC csvs carry one per row; lists
            # appear in rephraser-style pkls) — same dataset-level hook
            # as the reference's get_raw_item (datasets.py:212-218)
            return frames, (self._select_narration(narration), 1.0)
        if d == "ek100_cls":
            vid_path, start, end, narration, verb, noun = self.samples[i]
            ids = uniform_frame_ids(start, end, cfg.clip_length,
                                    jitter=self.is_training, rng=self.rng)
            frames = video_io.video_loader_by_frames(self.root, vid_path, ids)
            return frames, f"{verb}:{noun}"
        if d in ("egtea", "charades_ego"):
            vid_path, start, end, label = self.samples[i]
            frames = self._load_dense_or_sparse(vid_path, start, end)
            return frames, label
        if d == "charades_ego_trimmed":
            vid, start_s, end_s, narration = self.samples[i]
            frames = video_io.video_loader(
                self.root, vid, start_s, end_second=end_s, chunk_len=-1,
                fps=-1, clip_length=cfg.clip_length,
                jitter=self.is_training, rng=self.rng)
            return frames, narration
        raise NotImplementedError(d)


class VideoCaptionDataset(VideoMetadataBase):
    """(frames, caption_ids[, mask], relevancy) — dual-encoder training
    (reference VideoCaptionDatasetCLIP, datasets.py:337-387)."""

    def __init__(self, cfg, transform=None, tokenizer=None,
                 is_training=True, seed=None):
        super().__init__(cfg, is_training, seed)
        self.transform = transform
        self.tokenizer = tokenizer

    def __getitem__(self, i: int):
        frames, caption = self.get_raw_item(i)
        relevancy = 0.0
        if isinstance(caption, tuple):
            caption, relevancy = caption
        if self.transform is not None:
            frames = self.transform(frames)
        out = {"frames": frames.astype(np.float32),
               "relevancy": np.float32(relevancy)}
        if self.tokenizer is not None:
            tokens = self.tokenizer(caption)
            if isinstance(tokens, tuple):
                out["text"], out["mask"] = tokens
            else:
                out["text"] = tokens
        else:
            out["caption"] = caption
        return out


class VideoMcqDataset(VideoMetadataBase):
    """(query_ids, option_frames, option_ids, answer, type) for EgoMCQ
    (reference VideoCaptionDatasetMCQ, datasets.py:390-433)."""

    def __init__(self, cfg, transform=None, tokenizer=None,
                 is_training=False, seed=None):
        super().__init__(cfg, is_training, seed)
        self.transform = transform
        self.tokenizer = tokenizer

    def __getitem__(self, i: int):
        query, options, texts, answer, q_type = self.get_raw_item(i)
        if self.transform is not None:
            options = [self.transform(f) for f in options]
        out = {"frames_options": np.stack(options).astype(np.float32),
               "answer": np.int32(answer), "type": np.int32(q_type)}
        q = self.tokenizer(query)
        t = self.tokenizer(texts)
        if isinstance(q, tuple):
            out["query"], out["query_mask"] = q
            out["options"], out["options_mask"] = t
        else:
            out["query"], out["options"] = q, t
        return out


class VideoClassyDataset(VideoMetadataBase):
    """(frames, label or multi-hot) for classification fine-tune/eval
    (reference VideoClassyDataset, datasets.py:436-478)."""

    def __init__(self, cfg, transform=None, label_mapping=None,
                 is_training=True, seed=None):
        super().__init__(cfg, is_training, seed)
        self.transform = transform
        self.label_mapping = label_mapping

    def __getitem__(self, i: int):
        frames, label = self.get_raw_item(i)
        if self.transform is not None:
            frames = self.transform(frames)
        if self.label_mapping is not None:
            if isinstance(label, list):
                multi = np.zeros(len(self.label_mapping), np.float32)
                for lbl in label:
                    multi[self.label_mapping[lbl]] = 1.0
                label = multi
            else:
                label = np.int32(self.label_mapping[label])
        return {"frames": frames.astype(np.float32), "label": label}


class ConcatDataset:
    """Concatenation of datasets with a per-sample source indicator —
    used to mix ground-truth and pseudo narrations for the SSL loss
    (reference main_pretrain.py:284-313: GroundTruth/PseudoLabel
    ConcatDataset)."""

    def __init__(self, datasets: list, indicators: list[int]):
        assert len(datasets) == len(indicators)
        self.datasets = datasets
        self.indicators = indicators
        self._offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, i: int):
        k = int(np.searchsorted(self._offsets, i, side="right")) - 1
        item = self.datasets[k][i - int(self._offsets[k])]
        item["gt_indicators"] = np.int32(self.indicators[k])
        return item


def get_dataset(cfg: DatasetConfig, transform, tokenizer,
                is_training: bool = True, seed=None) -> VideoCaptionDataset:
    return VideoCaptionDataset(cfg, transform, tokenizer, is_training, seed)


def get_downstream_dataset(cfg: DatasetConfig, transform, label_mapping,
                           is_training: bool = True,
                           seed=None) -> VideoClassyDataset:
    return VideoClassyDataset(cfg, transform, label_mapping, is_training,
                              seed)
