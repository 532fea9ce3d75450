"""Atomic, async checkpointing of flat dicts of tensors, on npz + a manifest,
in the JAX package's on-disk layout (so the port restores what `repro.ckpt`
wrote):

    <dir>/step_00000123/
        manifest.json        {step, leaves: [{path, shape, dtype}], n_hosts, shards}
        shard_h0.npz         every leaf, as leaf_<i>
        COMMIT               written last — restore ignores dirs without it

Leaves are written in sorted key order with paths `['key']`, the order and
names JAX gives a flattened dict; a restore finds each key by its path.

  * atomic: COMMIT is written after the shard and the manifest, inside a
    temporary directory that is renamed into place; partial writes from a
    killed run are invisible to restore.
  * async: `CheckpointManager.save(blocking=False)` copies every tensor to
    host memory first, then writes in a background thread.

Single host. The JAX package's elastic and sharded restore waits for the
port of its `dist` layer.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from pathlib import Path
from typing import Iterable, Optional

import numpy as np
import torch


def _host(leaf) -> np.ndarray:
    """A host copy of one leaf (tensor, numpy array or scalar)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf)


def _path(key: str) -> str:
    return f"['{key}']"


def save_checkpoint(ckpt_dir, step: int, tree: dict) -> Path:
    """Write `tree` (a flat dict name -> leaf) as committed step `step`.
    Returns the step's directory."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    # the tmp name is unique per writer (process, thread, uuid), so two
    # writers of one directory never share or delete each other's tmp
    tmp = ckpt_dir / (f".tmp_step_{step:08d}_{os.getpid()}"
                      f"_{threading.get_ident()}_{uuid.uuid4().hex}")
    tmp.mkdir(parents=True)
    arrays, meta = {}, []
    for i, key in enumerate(sorted(tree)):
        arr = _host(tree[key])
        arrays[f"leaf_{i}"] = arr
        meta.append({"path": _path(key), "shape": list(arr.shape), "dtype": str(arr.dtype)})
    shard_name = "shard_h0.npz"  # one host
    np.savez(tmp / shard_name, **arrays)
    (tmp / "manifest.json").write_text(
        json.dumps({"step": step, "leaves": meta, "n_hosts": 1, "shards": [shard_name]}))
    (tmp / "COMMIT").write_text(str(time.time()))
    # commit: move an existing step of the same number aside to a unique
    # trash name first (rename is atomic), then retry; the last committer wins
    while True:
        try:
            tmp.rename(final)
            return final
        except OSError:
            trash = ckpt_dir / f".trash_{final.name}_{uuid.uuid4().hex}"
            try:
                final.rename(trash)
            except FileNotFoundError:
                continue  # another writer moved it first; retry our rename
            shutil.rmtree(trash, ignore_errors=True)


def _committed(ckpt_dir: Path) -> list[Path]:
    return sorted(p for p in ckpt_dir.iterdir()
                  if p.name.startswith("step_") and (p / "COMMIT").exists())


def latest_step(ckpt_dir) -> Optional[int]:
    """The newest committed step under `ckpt_dir`, or None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in _committed(ckpt_dir)]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir, keys: Iterable[str],
                       step: Optional[int] = None) -> tuple[dict, int]:
    """Read the leaves named `keys` of committed step `step` (the newest when
    None) as numpy arrays. Returns (dict, step); raises FileNotFoundError
    when there is no such committed step and KeyError when a key is
    missing."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    if not (d / "COMMIT").exists():
        raise FileNotFoundError(f"checkpoint {d} has no COMMIT marker")
    manifest = json.loads((d / "manifest.json").read_text())
    shards = manifest.get("shards", ["shard_h0.npz"])
    if len(shards) != 1:
        raise NotImplementedError(f"multi-shard restore is not supported (manifest declares "
                                  f"{shards})")
    where = {leaf["path"]: i for i, leaf in enumerate(manifest["leaves"])}
    with np.load(d / shards[0]) as data:
        out = {}
        for key in keys:
            if _path(key) not in where:
                raise KeyError(f"checkpoint {d} holds no leaf {key!r}")
            out[key] = data[f"leaf_{where[_path(key)]}"]
    return out, step


class CheckpointManager:
    """Keeps the last `keep` committed checkpoints; async background
    writes."""

    def __init__(self, ckpt_dir, keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: dict, blocking: bool = True) -> None:
        """Checkpoint `tree` as step `step`. The tensors are copied to host
        memory before this returns; with `blocking=False` the write runs in
        a background thread (one at a time)."""
        host_tree = {k: _host(v) for k, v in tree.items()}  # snapshot
        self.wait()
        if blocking:
            self._write(step, host_tree)
        else:
            self._thread = threading.Thread(target=self._write, args=(step, host_tree),
                                            daemon=True)
            self._thread.start()

    def _write(self, step: int, host_tree: dict) -> None:
        save_checkpoint(self.dir, step, host_tree)
        for p in _committed(self.dir)[: -self.keep]:
            shutil.rmtree(p, ignore_errors=True)

    def wait(self) -> None:
        """Block until the background write, if any, has committed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
