"""Label-space construction for zero-shot / fine-tune classification.

Equivalent of the reference's generate_label_map
(reference: lavila/utils/preprocess.py:12-64) with explicit paths instead
of hardcoded dataset locations.

  * ek100_cls: action space = sorted unique 'verb:noun' pairs from the
    train+val csvs; label text = the set of narrations seen for the pair.
  * charades_ego: Charades_v1_classes.txt ('cXXX description' lines).
  * egtea: action_idx.txt ('name_with_underscores idx' lines).
"""

from __future__ import annotations

import csv
import os.path as osp
from typing import Optional


def generate_label_map(dataset: str, metadata: str = "",
                       extra_metadata: Optional[str] = None):
    """Returns (labels, mapping) where labels[i] is the prompt text (or a
    list of texts) for class i and mapping maps the dataset's raw label
    key → class index."""
    if dataset == "ek100_cls":
        files = [metadata]
        if extra_metadata:
            files.append(extra_metadata)
        else:
            # train+validation convention next to the given csv
            d = osp.dirname(metadata)
            for name in ("EPIC_100_train.csv", "EPIC_100_validation.csv"):
                p = osp.join(d, name)
                if p not in files and osp.exists(p):
                    files.append(p)
        vn_list = []
        vn2narration: dict[str, list[str]] = {}
        for f in files:
            if not osp.exists(f):
                continue
            with open(f) as fh:
                reader = csv.reader(fh)
                next(reader)
                for row in reader:
                    vn = f"{int(row[10])}:{int(row[12])}"
                    if vn not in vn2narration:
                        vn_list.append(vn)
                        vn2narration[vn] = []
                    vn2narration[vn].append(row[8])
        vn_list = sorted(vn_list)
        mapping = {vn: i for i, vn in enumerate(vn_list)}
        labels = [sorted(set(vn2narration[vn])) for vn in vn_list]
        return labels, mapping
    if dataset == "charades_ego":
        labels, vn_list = [], []
        with open(metadata) as fh:
            for row in fh:
                row = row.strip()
                if not row:
                    continue
                vn_list.append(row[:4])
                labels.append(row[5:])
        return labels, {vn: i for i, vn in enumerate(vn_list)}
    if dataset == "egtea":
        labels = []
        with open(metadata) as fh:
            for row in fh:
                row = row.strip()
                if not row:
                    continue
                name = " ".join(row.split(" ")[:-1])
                labels.append(name.replace("_", " ").lower())
        return labels, {label: i for i, label in enumerate(labels)}
    raise NotImplementedError(dataset)


def actions_to_parts(mapping: dict) -> "np.ndarray":
    """(num_actions, 2) verb/noun ids per action for EK-100 CLS
    marginalization."""
    import numpy as np
    arr = np.zeros((len(mapping), 2), np.int64)
    for vn, i in mapping.items():
        v, n = vn.split(":")
        arr[i] = (int(v), int(n))
    return arr
