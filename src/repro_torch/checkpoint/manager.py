"""Fault-tolerant checkpointing: atomic, hashed, async.

The on-disk layout is the reference's, so a checkpoint either package
wrote restores in the other:

    <dir>/step_0000000420/
        manifest.json     leaf shapes, dtypes, per-leaf sha256
        leaf_00000.npy ... one file per tree leaf (np.save, dtypes as-is)
    <dir>/LATEST          text file naming the newest *complete* step dir

Leaves are numbered in ``jax.tree_util`` order: dict keys sorted at every
level, tuples and lists in order, ``None`` holding no leaf.

Guarantees:
  * atomicity  — written to ``.tmp-<step>`` then renamed; a crash
    mid-write can never corrupt LATEST (rename is atomic on POSIX).
  * integrity  — restore verifies each leaf's sha256 against the manifest;
    a corrupted checkpoint raises and ``restore_latest(...,
    allow_fallback=True)`` falls back to the previous step.
  * async      — ``save_async`` snapshots every tensor to host numpy
    before it returns (training may go on and change the tensors) and
    writes on a daemon thread; ``wait`` joins.
  * elastic    — a DTensor leaf is saved whole (``full_tensor``: every
    rank of its mesh must call ``save``), and ``restore`` /
    ``restore_latest(..., shardings=)`` bring each leaf back as a DTensor
    with the requested ``(mesh, placements)``, whatever layout it was
    saved from.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

__all__ = ["CheckpointManager"]


def _flatten(tree: Any) -> list[Any]:
    """The leaves of nested dicts, tuples and lists in jax's order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for node in tree for leaf in _flatten(node)]
    if tree is None:
        return []
    return [tree]


def _unflatten(like: Any, leaves: list[Any]) -> Any:
    """``like``'s structure with its leaves taken from ``leaves`` in
    order (consumed from the front)."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(node, leaves) for node in like)
    if like is None:
        return None
    return leaves.pop(0)


def _pick(like: Any, tree: Any) -> list[Any]:
    """The nodes of ``tree`` at the leaf positions of ``like`` (a
    ``shardings`` tree, whose leaves are ``(mesh, placements)`` pairs or
    None), in ``_flatten``'s order."""
    if isinstance(like, dict):
        return [n for k in sorted(like) for n in _pick(like[k], tree[k])]
    if isinstance(like, (tuple, list)):
        return [n for a, b in zip(like, tree) for n in _pick(a, b)]
    if like is None:
        return []
    return [tree]


def _to_host(leaf: Any) -> np.ndarray:
    """A host copy of ``leaf`` that later changes to it cannot reach (a
    DTensor's whole value)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3) -> None:
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ----- write path ---------------------------------------------------------
    def save(self, step: int, tree: Any) -> str:
        return self._write(step, [_to_host(x) for x in _flatten(tree)])

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
        host = [_to_host(x) for x in _flatten(tree)]  # snapshot first
        self._thread = threading.Thread(
            target=self._write, args=(step, host), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_leaves: list[np.ndarray]) -> str:
        name = f"step_{step:010d}"
        tmp = os.path.join(self.dir, f".tmp-{name}")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "treedef": f"{len(host_leaves)} leaves",
                    "leaves": []}
        for i, arr in enumerate(host_leaves):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append({
                "file": fname, "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "sha256": _sha256(os.path.join(tmp, fname))})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(self.dir, ".tmp-LATEST"), "w") as f:
            f.write(name)
        os.replace(os.path.join(self.dir, ".tmp-LATEST"),
                   os.path.join(self.dir, "LATEST"))
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ----- read path --------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for n in os.listdir(self.dir):
            if n.startswith("step_"):
                try:
                    out.append(int(n[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        path = os.path.join(self.dir, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            name = f.read().strip()
        try:
            return int(name[5:])
        except ValueError:
            return None

    def restore(self, step: int, like: Any, *, shardings: Any | None = None,
                verify: bool = True) -> Any:
        """Restore into the structure of ``like`` (nested dicts, tuples and
        lists of tensors or arrays).  Each leaf comes back as a tensor in
        its saved dtype, on the device of ``like``'s leaf when that is a
        tensor, else on the CPU.  ``shardings``, a tree of ``like``'s
        structure with ``(mesh, placements)`` leaves, brings each leaf
        back as a DTensor with exactly those placements: every rank reads
        the whole leaf and keeps its own shard, with no communication."""
        base = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(base, "manifest.json")) as f:
            manifest = json.load(f)
        targets = _flatten(like)
        if len(manifest["leaves"]) != len(targets):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, "
                f"target structure has {len(targets)}")
        shards = (_pick(like, shardings) if shardings is not None
                  else [None] * len(targets))
        out = []
        for entry, tgt, shd in zip(manifest["leaves"], targets, shards):
            path = os.path.join(base, entry["file"])
            if verify and _sha256(path) != entry["sha256"]:
                raise IOError(f"checksum mismatch in {path}")
            arr = np.load(path)
            want = tuple(tgt.shape if isinstance(tgt, torch.Tensor)
                         else np.shape(tgt))
            if tuple(arr.shape) != want:
                raise ValueError(f"shape mismatch {arr.shape} vs "
                                 f"{want} for "
                                 f"{entry['file']}")
            if shd is not None:
                mesh, placements = shd
                out.append(distribute_tensor(torch.from_numpy(arr), mesh,
                                             placements, src_data_rank=None))
                continue
            dev = tgt.device if isinstance(tgt, torch.Tensor) else "cpu"
            out.append(torch.from_numpy(arr).to(dev))
        return _unflatten(like, out)

    def restore_latest(self, like: Any, *, shardings: Any | None = None,
                       allow_fallback: bool = True):
        """Returns (step, tree) from the newest valid checkpoint, walking
        backwards past corrupted ones when ``allow_fallback``; with
        ``shardings`` as in :meth:`restore`."""
        candidates = sorted(self.steps(), reverse=True)
        last_err: Exception | None = None
        for step in candidates:
            try:
                return step, self.restore(step, like, shardings=shardings)
            except (OSError, ValueError, KeyError) as e:
                # corrupted or incomplete -> try older
                last_err = e
                if not allow_fallback:
                    raise
        if last_err is not None:
            raise last_err
        return None, None
