"""Checkpoint / resume for long multi-scan runs (port of
vtkcloudpoint_tpu.utils.checkpoint).

Saves and restores trees of tensors -- nested dicts, lists, tuples and
NamedTuples, as ``convert._map`` walks them -- as one ``.npz`` file with the
JAX module's keys: ``leaf_i`` for the i-th leaf, ``__step__`` and
``__treedef__``. Leaves are numbered in ``jax.tree.flatten`` order (dict
keys sorted, None holding no leaf), so each package restores a file the
other wrote for the same structure.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


def _children(tree):
    """(kind, children) of a tree node, or None for a leaf."""
    if isinstance(tree, dict):
        return "dict", [tree[k] for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return "namedtuple", list(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree).__name__, list(tree)
    if tree is None:
        return "none", []
    return None


def flatten(tree) -> list:
    """The leaves of ``tree`` in jax.tree.flatten order."""
    node = _children(tree)
    if node is None:
        return [tree]
    return [leaf for child in node[1] for leaf in flatten(child)]


def unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` (an iterator)."""
    node = _children(like)
    if node is None:
        return next(leaves)
    kind, _ = node
    if kind == "dict":
        out = {k: None for k in like}
        for k in sorted(like):
            out[k] = unflatten(like[k], leaves)
        return out
    if kind == "none":
        return None
    kids = [unflatten(child, leaves) for child in like]
    if kind == "namedtuple":
        return type(like)(*kids)
    return type(like)(kids)


def treedef_str(tree) -> str:
    """The structure as ``str(jax.tree.structure(tree))`` prints it."""

    def walk(t):
        node = _children(t)
        if node is None:
            return "*"
        kind, kids = node
        if kind == "dict":
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if kind == "none":
            return "None"
        inner = ", ".join(walk(k) for k in kids)
        if kind == "namedtuple":
            return (f"CustomNode(namedtuple[{type(t).__name__}], "
                    f"[{inner}])")
        if kind == "list":
            return f"[{inner}]"
        return f"({inner}{',' if len(kids) == 1 else ''})"

    return f"PyTreeDef({walk(tree)})"


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(path: str, tree, step: int = 0) -> str:
    """Save a tree of tensors (or arrays). Returns the written file path."""
    leaves = flatten(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    np.savez_compressed(path, __treedef__=np.frombuffer(
        treedef_str(tree).encode(), dtype=np.uint8), __step__=np.int64(step),
        **arrays)
    return path if path.endswith(".npz") else path + ".npz"


def restore(path: str, like):
    """Restore into the structure of ``like`` (a template tree). A leaf
    whose template is a tensor comes back as a tensor on that tensor's
    device, any other as a numpy array; dtypes are the file's.

    Returns (tree, step)."""
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    data = np.load(path, allow_pickle=False)
    templates = flatten(like)
    leaves = []
    for i, t in enumerate(templates):
        a = data[f"leaf_{i}"]
        if isinstance(t, torch.Tensor):
            a = torch.from_numpy(np.array(a, copy=True)).to(t.device)
        leaves.append(a)
    step = int(data["__step__"]) if "__step__" in data else 0
    return unflatten(like, iter(leaves)), step


class CheckpointManager:
    """Rolling step-numbered checkpoints with a small JSON index."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._index_path = os.path.join(directory, "index.json")

    def _index(self):
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                return json.load(f)
        return {"steps": []}

    def save(self, step: int, tree):
        p = os.path.join(self.directory, f"ckpt_{step}.npz")
        save(p, tree, step)
        idx = self._index()
        idx["steps"] = sorted(set(idx["steps"] + [step]))
        while len(idx["steps"]) > self.keep:
            old = idx["steps"].pop(0)
            old_p = os.path.join(self.directory, f"ckpt_{old}.npz")
            if os.path.exists(old_p):
                os.remove(old_p)
        with open(self._index_path, "w") as f:
            json.dump(idx, f)
        return p

    def latest_step(self):
        idx = self._index()
        return idx["steps"][-1] if idx["steps"] else None

    def restore_latest(self, like):
        step = self.latest_step()
        if step is None:
            return None, None
        p = os.path.join(self.directory, f"ckpt_{step}.npz")
        tree, _ = restore(p, like)
        return tree, step
