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
    """A leaf as numpy; a bf16 tensor as its 16-bit patterns (``|V2``, the
    bytes the reference's ``ml_dtypes`` bfloat16 arrays are saved as)."""
    if isinstance(leaf, torch.Tensor):
        if hasattr(leaf, "full_tensor"):      # a DTensor: its whole value
            leaf = leaf.full_tensor()
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.dtype("V2"))
        return leaf.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


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
            "dtype": _dtype_name(leaf, arr),
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

    Each leaf keeps the checkpoint's dtype (bfloat16 too, which the
    reference saves as 16-bit patterns) and goes to the device of the
    target's leaf (the CPU where the target's leaf is not a tensor or is a
    ``device="meta"`` one, as ``models.model.param_shapes`` makes).
    ``shardings``, a tree of the target's structure whose leaves are
    ``torch.device``s, device strings, ``distributed.sharding.NamedSharding``s
    (as ``param_shardings`` / ``opt_shardings`` give them) or None, places
    each restored leaf on its device instead, or as a ``DTensor`` on the
    sharding's mesh (the reference's elastic restart onto a new mesh); None
    keeps the target leaf's.  A tree of another structure raises
    ``ValueError``.
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
    bf16 = set()
    for k, info in index.items():
        key = info["key"]
        arr = arrays[k]
        if info["dtype"] == "bfloat16":   # numpy has no bfloat16: its bit patterns
            bf16.add(key)
            arr = arr.view(np.int16)
        if key not in globals_:
            dt = np.int16 if key in bf16 else np.dtype(info["dtype"])
            globals_[key] = np.zeros(info["global_shape"], dtype=dt)
        if info["slice"] is None:
            globals_[key] = arr
        else:
            sl = tuple(slice(a, b, c) for a, b, c in info["slice"])
            globals_[key][sl] = arr

    def leaf(key, target):
        dev = placement.get(key)
        sh = None
        if dev is not None and hasattr(dev, "placements"):    # a NamedSharding
            sh = dev
            dt = sh.mesh.device_type
            dev = torch.device("cuda", torch.cuda.current_device()) if dt == "cuda" else dt
        if dev is None:
            on_target = isinstance(target, torch.Tensor) and target.device.type != "meta"
            dev = target.device if on_target else "cpu"
        t = torch.as_tensor(globals_[key], device=torch.device(dev))
        t = t.view(torch.bfloat16) if key in bf16 else t
        if sh is not None:
            from ..distributed.sharding import shard_leaf

            t = shard_leaf(t, sh)
        return t

    return _map_with_path(leaf, target_tree)


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(p for p in ckpt_dir.iterdir() if p.name.startswith("step_"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)
