"""Atomic checkpoints in the JAX package's on-disk layout
(``repro/train/checkpoint.py``), so either package restores the other's.

``step_{step:010d}/shards_host0.npz`` holds ``leaf_{i}`` for the tree's
leaves in the JAX order (dict keys sorted, NamedTuple fields in order: a
``TrainState`` is ``params``, then ``opt.step``, ``opt.mu``, ``opt.nu``);
``manifest.json`` records step, ``n_leaves``, shapes and dtypes, and a
``treedef`` string that is informational only (the two packages describe
their trees differently).  A write goes to a temp dir, is fsynced and
renamed into place, so a crashed write never corrupts the previous
checkpoint; ``keep`` newest are retained.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train.tree import leaves, unflatten


def _treedef(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        name = type(tree).__name__
        return f"{name}(" + ", ".join(_treedef(t) for t in tree) + ")"
    return "*"


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Atomically write the checkpoint for ``step``; prune old ones."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrs = [_numpy(x) for x in leaves(tree)]
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_step{step}_")
    try:
        np.savez(os.path.join(tmp, "shards_host0.npz"),
                 **{f"leaf_{i}": a for i, a in enumerate(arrs)})
        manifest = {
            "step": int(step),
            "treedef": _treedef(tree),
            "n_leaves": len(arrs),
            "shapes": [list(a.shape) for a in arrs],
            "dtypes": [str(a.dtype) for a in arrs],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(ckpt_dir, f"step_{step:010d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.startswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                out.append(int(name[len("step_"):]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like``: each leaf a tensor of the
    matching ``like`` leaf's dtype, device and ``requires_grad``;
    the leaf count and shapes are checked."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like_leaves = leaves(like)
    if manifest["n_leaves"] != len(like_leaves):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves; structure "
            f"expects {len(like_leaves)}")
    out = []
    with np.load(os.path.join(path, "shards_host0.npz")) as data:
        for i, leaf in enumerate(like_leaves):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} "
                                 f"!= {tuple(leaf.shape)}")
            t = torch.from_numpy(np.array(arr)).to(dtype=leaf.dtype,
                                                   device=leaf.device)
            if leaf.requires_grad:
                t.requires_grad_(True)
            out.append(t)
    return unflatten(like, out)
