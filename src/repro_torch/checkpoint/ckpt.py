"""Atomic, async checkpoints in the reference's format.

Counterpart of ``repro.checkpoint.ckpt``, file for file interchangeable
with it:

    <dir>/step_<N>.tmp/      (written)
    <dir>/step_<N>/          (atomic rename on completion)
        manifest.json        keys, shapes, dtypes, step, quant policy
        arr_<k>.npy          one file per leaf

A tree is nested dicts of numpy arrays (or tensors); a LutqState leaf
flattens to ``__lutq__w`` / ``__lutq__d`` / ... keys and None to a
``key@none`` entry. A port :class:`~repro_torch.optim.train_state.TrainState`
is saved as the reference's ``state_flat`` tree
(:func:`repro_torch.interop.train_state_to_numpy`: stacked ``layers/...``
keys, ``__lutq_d`` / ``__lutq_a`` static keys), so a JAX run restores it
and the port restores a JAX run's. :func:`restore_params` maps only the
parameters of a train checkpoint, for serving. Writes go to ``.tmp`` and are renamed
when complete; ``keep_n`` prunes old steps. Sharded (per-host) writes,
meshes and tuning caches are not ported (ROADMAP queue 1, multi-GPU;
tuning and benches).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.lutq import LutqState
from repro_torch.core.rules import QuantPolicy


def _flatten(tree, prefix="") -> List[Tuple[str, Any]]:
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, LutqState):
        node = {"__lutq__w": tree.w, "__lutq__d": tree.d, "__lutq__a": tree.a}
        if tree.sid is not None:
            node["__lutq__sid"] = tree.sid
        if tree.act is not None:
            node["__lutq__act"] = tree.act
        out += _flatten(node, prefix)
    elif tree is None:
        out.append((prefix.rstrip("/") + "@none", None))
    else:
        out.append((prefix.rstrip("/"), tree))
    return out


def _unflatten(items: Dict[str, Any]):
    tree: Dict[str, Any] = {}
    for key, val in items.items():
        if key.endswith("@none"):
            key, val = key[: -len("@none")], None
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def rebuild(node):
        if isinstance(node, dict):
            if "__lutq__w" in node:
                return LutqState(w=node["__lutq__w"], d=node["__lutq__d"],
                                 a=node["__lutq__a"],
                                 sid=node.get("__lutq__sid"),
                                 act=node.get("__lutq__act"))
            return {k: rebuild(v) for k, v in node.items()}
        return node

    return rebuild(tree)


def _host(tree):
    """The tree with every leaf a numpy array on the host (a TrainState
    becomes its reference ``state_flat`` tree)."""
    from repro_torch.interop import _numpy, train_state_to_numpy
    from repro_torch.optim.train_state import TrainState

    if isinstance(tree, TrainState):
        return train_state_to_numpy(tree)
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, LutqState):
        return LutqState(*(_host(x) for x in tree))
    if isinstance(tree, torch.Tensor):
        return _numpy(tree)
    return None if tree is None else np.asarray(tree)


def save(tree, directory: str, step: int, *, keep_n: int = 3,
         policy: Optional[QuantPolicy] = None) -> str:
    """Synchronous checkpoint write. Returns the final path.

    ``policy``: the QuantPolicy governing the LutqState leaves, stored in
    the manifest (see :func:`load_policy`).
    """
    tree = _host(tree)
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f"step_{step:08d}.tmp"
    final = d / f"step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "leaves": []}
    if policy is not None:
        manifest["quant_policy"] = policy.to_json_dict()
    for i, (key, val) in enumerate(_flatten(tree)):
        entry = {"key": key, "file": None}
        if val is not None:
            fname = f"arr_{i:05d}.npy"
            np.save(tmp / fname, val)
            entry.update(file=fname, shape=list(val.shape),
                         dtype=str(val.dtype))
        manifest["leaves"].append(entry)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(d, keep_n)
    return str(final)


def _gc(d: Path, keep_n: int):
    steps = sorted(p for p in d.glob("step_????????") if p.is_dir())
    for p in steps[:-keep_n] if keep_n > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


class AsyncCheckpointer:
    """Snapshot to the host synchronously, write on a background thread."""

    def __init__(self, directory: str, keep_n: int = 3,
                 policy: Optional[QuantPolicy] = None):
        self.directory = directory
        self.keep_n = keep_n
        self.policy = policy
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.last_path: Optional[str] = None

    def save(self, tree, step: int):
        self.wait()  # one outstanding write at a time
        host_tree = _host(tree)

        def _write():
            try:
                self.last_path = save(host_tree, self.directory, step,
                                      keep_n=self.keep_n, policy=self.policy)
            except Exception as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the outstanding write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(directory: str) -> Optional[int]:
    d = Path(directory)
    if not d.exists():
        return None
    steps = sorted(p.name for p in d.glob("step_????????") if p.is_dir()
                   and (p / "manifest.json").exists())
    return int(steps[-1].split("_")[1]) if steps else None


def _manifest(directory: str, step: Optional[int]) -> Tuple[Path, Dict, int]:
    """(step dir, parsed manifest, resolved step) for a checkpoint."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    d = Path(directory) / f"step_{step:08d}"
    return d, json.loads((d / "manifest.json").read_text()), step


def load_policy(directory: str, step: Optional[int] = None
                ) -> Optional[QuantPolicy]:
    """QuantPolicy stored with a checkpoint, or None (fp / legacy)."""
    _, manifest, _ = _manifest(directory, step)
    pol = manifest.get("quant_policy")
    return None if pol is None else QuantPolicy.from_json_dict(pol)


def restore(directory: str, step: Optional[int] = None):
    """Load a checkpoint as (numpy tree, step). A train state's tree goes
    into a port state with :func:`repro_torch.interop.load_train_state`."""
    d, manifest, step = _manifest(directory, step)
    items = {}
    for entry in manifest["leaves"]:
        items[entry["key"]] = (None if entry["file"] is None
                               else np.load(d / entry["file"]))
    return _unflatten(items), manifest["step"]


def load(directory: str, step: Optional[int] = None):
    """Alias of :func:`restore`."""
    return restore(directory, step)


def restore_params(directory: str, step: Optional[int] = None):
    """Restore only the ``{"trainable", "static"}`` subtrees of a train
    checkpoint, which is what serving needs: the optimizer moments (the
    bulk of the state) are never opened, and the leaves are read-only
    memory maps, so the caller pays pages only for what it copies.
    Returns ``({"trainable", "static"}, step)``; the serve model is
    :func:`repro_torch.interop.from_train_params`.
    """
    d, manifest, step = _manifest(directory, step)
    items = {}
    for entry in manifest["leaves"]:
        key = entry["key"]
        if not key.startswith(("trainable/", "static/")):
            continue
        items[key] = (None if entry["file"] is None
                      else np.load(d / entry["file"], mmap_mode="r"))
    return _unflatten(items), step
