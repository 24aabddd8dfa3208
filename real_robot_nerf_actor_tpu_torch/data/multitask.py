"""Multi-kitchen, multi-task dataset manifests (the port's copy of the JAX
package's `data/multitask.py`).

A dataset written by `data/kitchen.write_multi_kitchen_dataset` holds one
recording per (kitchen, task) in k{i}_t{j}/, manifest.json and
lang_embs.npz; `load_multitask_entries` turns it into the entry list that
the trainers' `multi_replay_data` takes.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def load_multitask_entries(root: str, exclude_demos: Tuple[int, ...] = (),
                           n_demos: Optional[int] = None) -> List[Dict]:
    """Entries for `multi_replay_data` from a multi-kitchen dataset root.
    exclude_demos holds those demo ids out of training in every (kitchen,
    task). Each entry carries its kitchen and task ids and its instruction."""
    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    lang = np.load(os.path.join(root, "lang_embs.npz"))["embs"]
    entries = []
    for e in manifest["entries"]:
        entries.append({
            "root": os.path.join(root, e["dir"]),
            "n_demos": int(n_demos if n_demos is not None else e["n_demos"]),
            "lang": lang[e["task"]].astype(np.float32),
            "exclude_demos": tuple(exclude_demos),
            "kitchen": int(e["kitchen"]),
            "task": int(e["task"]),
            "instruction": e["instruction"],
        })
    return entries
