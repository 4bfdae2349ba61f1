"""Atomic checkpoints (the reference's ``repro/runtime/checkpoint.py``).

Layout, the reference's: ``<dir>/step_<N>/`` holds ``manifest.json`` and
one ``.npy`` per leaf, named by the leaf's path joined with ``__`` (dict
keys, sequence indices, ``.field`` for a NamedTuple field, as
``jax.tree_util``'s key paths print).  Writes go to ``step_<N>.tmp`` and
are published by one atomic rename, so a crashed writer never shadows the
latest complete checkpoint.  A bf16 leaf is stored as its 16-bit pattern
(numpy has no bf16) with ``"bfloat16"`` in the manifest.

``restore(..., device=)`` places the leaves on one device.  The
reference's ``shardings=`` (restore onto another mesh) waits for
ROADMAP A11 (sharding on ``torch.distributed``) and raises.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from .. import resolve_device
from .tree import tree_paths, tree_unflatten


def _name(path) -> str:
    return "__".join(k if isinstance(k, str) else str(k) for k in path)


def _leaf_files(tree) -> list:
    """``[(file stem, leaf), ...]`` in tree order."""
    return [(_name(path), leaf) for path, leaf in tree_paths(tree)]


def _to_numpy(leaf) -> tuple:
    """(array to save, manifest dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    """Atomic checkpoint write of a tree of tensors.  Returns the final
    directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for name, leaf in _leaf_files(tree):
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"][name] = {"shape": list(arr.shape), "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)   # atomic publish
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _load_leaf(d: str, name: str, manifest: dict) -> torch.Tensor:
    """One saved leaf of the checkpoint directory ``d`` as a CPU tensor."""
    arr = np.load(os.path.join(d, name + ".npy"))
    t = torch.from_numpy(arr)
    if manifest["leaves"].get(name, {}).get("dtype") == "bfloat16":
        t = t.view(torch.bfloat16)
    return t


def restore(ckpt_dir: str, step: int, like_tree, shardings=None,
            device="cuda"):
    """Restore into the structure of ``like_tree`` (each saved leaf's shape
    must equal its like leaf's), every leaf on ``device``.  Returns (tree,
    extra dict)."""
    if shardings is not None:
        raise NotImplementedError(
            "repro_torch checkpoint.restore: shardings (restoring onto "
            "another mesh) need ROADMAP A11, sharding on torch.distributed")
    dev = resolve_device(device)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    for name, like in _leaf_files(like_tree):
        t = _load_leaf(d, name, manifest)
        if list(t.shape) != list(like.shape):
            raise ValueError(f"checkpoint leaf {name}: shape "
                             f"{tuple(t.shape)}, expected "
                             f"{tuple(like.shape)}")
        leaves.append(t.to(dev))
    return tree_unflatten(like_tree, leaves), manifest["extra"]
