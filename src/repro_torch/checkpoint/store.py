"""Checkpointing with atomic commit, in the reference's on-disk layout.

Layout:  <dir>/step_<N>/host_<i>.npz (one file per host, each leaf keyed by
its flattened tree path and ``||<shard>``), index_<i>.json (each array's key,
slice, global shape and dtype) and meta.json with the step.  A save is
written under ``_tmp_step_<N>`` and committed with a directory rename, so a
crash mid-save never corrupts the latest checkpoint.

The port keeps the reference's files exactly: a checkpoint written by
either package restores in the other.  Tree paths are the strings of
``jax.tree_util.tree_flatten_with_path`` (``.lock`` for a NamedTuple field,
``w`` for a dict key, ``blocks/0/a`` nested), without jax: NamedTuples,
dicts (in sorted key order), lists and tuples are nodes, ``None`` is an
empty node, anything else a leaf.  A tensor is one device's whole array, so
every leaf is stored once, as ``<key>||-1`` with ``"slice": null``;
``restore`` also assembles the reference's per-shard slices.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map_with_path(fn: Callable[[str, Any], Any], tree, path: tuple = ()):
    """``tree`` rebuilt with every leaf replaced by ``fn(key, leaf)``; dict
    leaves are visited in sorted key order, as jax flattens them."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_path(fn, v, path + (f".{f}",))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    if isinstance(tree, dict):
        out = {k: _map_with_path(fn, tree[k], path + (str(k),)) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    return fn("/".join(path), tree)


def _flat_up_to(tree, other) -> Dict[str, Any]:
    """``other``'s subtrees at the leaves of ``tree``, keyed by their paths:
    ``other`` must have ``tree``'s structure down to its leaves (as
    ``treedef.flatten_up_to`` requires in the reference), else
    ``ValueError``."""
    out: Dict[str, Any] = {}

    def walk(a, b, path):
        def mismatch():
            raise ValueError(
                f"shardings do not match the target's structure at "
                f"{'/'.join(path) or '<root>'}: {type(b).__name__} against "
                f"{type(a).__name__}")

        if a is None:
            if b is not None:
                mismatch()
        elif _is_namedtuple(a):
            if type(b) is not type(a):
                mismatch()
            for f, x, y in zip(a._fields, a, b):
                walk(x, y, path + (f".{f}",))
        elif isinstance(a, (list, tuple)):
            if type(b) is not type(a) or len(b) != len(a):
                mismatch()
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, path + (str(i),))
        elif isinstance(a, dict):
            if not isinstance(b, dict) or set(b) != set(a):
                mismatch()
            for k in sorted(a):
                walk(a[k], b[k], path + (str(k),))
        else:
            out["/".join(path)] = b

    walk(tree, other, ())
    return out


def _flat(tree) -> Dict[str, Any]:
    """Flattened path key -> leaf, in the reference's order."""
    out: Dict[str, Any] = {}
    _map_with_path(out.__setitem__, tree)
    return out


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str | Path, step: int, tree, *, host_id: int = 0,
         keep: int = 3) -> Path:
    """Write every leaf of ``tree`` (tensors on any device); atomic rename
    commit; keep the newest ``keep`` steps."""
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f"_tmp_step_{step:08d}"
    final = ckpt_dir / f"step_{step:08d}"
    tmp.mkdir(parents=True, exist_ok=True)

    arrays: Dict[str, np.ndarray] = {}
    index: Dict[str, Dict] = {}
    for key, leaf in _flat(tree).items():
        arr = _host_array(leaf)
        arrays[f"{key}||-1"] = arr
        index[f"{key}||-1"] = {
            "key": key,
            "slice": None,
            "global_shape": list(arr.shape),
            "dtype": str(arr.dtype),
        }
    np.savez(tmp / f"host_{host_id}.npz", **arrays)
    (tmp / f"index_{host_id}.json").write_text(json.dumps(index))
    (tmp / "meta.json").write_text(json.dumps({"step": step, "time": time.time()}))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    """The newest committed step under ``ckpt_dir``, or None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
             if p.name.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir: str | Path, step: int, target_tree, shardings=None):
    """Rebuild ``target_tree``'s structure from the checkpoint of ``step``.

    Each leaf keeps the checkpoint's dtype and goes to the device of the
    target's leaf (the CPU where the target's leaf is not a tensor).
    ``shardings``, a tree of the target's structure whose leaves are
    ``torch.device``s, device strings or None, places each restored leaf on
    its device instead (None keeps the target leaf's); a tree of another
    structure raises ``ValueError``.
    """
    placement = _flat_up_to(target_tree, shardings) if shardings is not None else {}
    d = Path(ckpt_dir) / f"step_{step:08d}"
    arrays: Dict[str, np.ndarray] = {}
    index: Dict[str, Dict] = {}
    for f in sorted(d.glob("host_*.npz")):
        with np.load(f) as z:
            arrays.update({k: z[k] for k in z.files})
    for f in sorted(d.glob("index_*.json")):
        index.update(json.loads(f.read_text()))

    # assemble per-key global arrays (the reference's shards by slice)
    globals_: Dict[str, np.ndarray] = {}
    for k, info in index.items():
        key = info["key"]
        if key not in globals_:
            globals_[key] = np.zeros(info["global_shape"], dtype=np.dtype(info["dtype"]))
        if info["slice"] is None:
            globals_[key] = arrays[k]
        else:
            sl = tuple(slice(a, b, c) for a, b, c in info["slice"])
            globals_[key][sl] = arrays[k]

    def leaf(key, target):
        dev = placement.get(key)
        if dev is None:
            dev = target.device if isinstance(target, torch.Tensor) else "cpu"
        return torch.as_tensor(globals_[key], device=torch.device(dev))

    return _map_with_path(leaf, target_tree)


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(p for p in ckpt_dir.iterdir() if p.name.startswith("step_"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)
