"""Checkpoint/restore with async snapshots (twin of
``repro.checkpoint.checkpoint``), in the reference's on-disk layout, so a
checkpoint written by either package restores in the other.

Layout: one ``step_%08d`` directory per step holding a ``manifest.json``
(flat key -> file, shape, dtype, shard id) and one ``.npy`` per leaf.
Keys are ``repro_torch.tree`` keys (dict key, tuple index or NamedTuple
field per level, joined by ``/``); a key's file name replaces ``/`` by
``__``. A bfloat16 leaf is saved as its raw little-endian bytes, shape
``+ (2,)`` uint8, under the dtype name ``"bfloat16"``. Writes go to a
temp directory renamed into place, so a crash mid-save never leaves a
partial step: restore picks the newest step whose manifest exists.

Leaves are saved whole; ``restore`` places them on the device asked for,
so a run checkpointed on N ranks resumes on M.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib

#: dtypes numpy lacks, saved as raw bytes: name -> (torch dtype, bytes)
RAW_DTYPES = {"bfloat16": (torch.bfloat16, 2)}


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(the array to save, the manifest's dtype name)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        raw = t.reshape(-1).view(torch.uint8).reshape(tuple(t.shape) + (2,))
        return raw.numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, meta: dict) -> torch.Tensor:
    shape = tuple(meta["shape"])
    if meta["dtype"] in RAW_DTYPES and str(arr.dtype) != meta["dtype"]:
        dtype, width = RAW_DTYPES[meta["dtype"]]
        raw = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint8))
        return raw.reshape(-1, width).view(dtype).reshape(shape)
    return torch.from_numpy(np.ascontiguousarray(arr)).reshape(shape)


def save(path, step: int, tree: Any) -> pathlib.Path:
    """Synchronous atomic checkpoint of a tree of tensors (or arrays)."""
    root = pathlib.Path(path)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {}
    for key, leaf in tree_lib.keyed(tree).items():
        arr, logical = _to_numpy(torch.as_tensor(leaf))
        fname = key.replace("/", "__") + ".npy"
        np.save(tmp / fname, arr)
        manifest[key] = dict(file=fname, shape=list(np.shape(leaf)),
                             dtype=logical, shard_id=0)
    (tmp / "manifest.json").write_text(json.dumps(
        dict(step=step, leaves=manifest), indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def latest_step(path) -> Optional[int]:
    root = pathlib.Path(path)
    if not root.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in root.iterdir()
             if d.name.startswith("step_") and (d / "manifest.json").exists()]
    return max(steps) if steps else None


def restore(path, like: Any, step: Optional[int] = None, device=None
            ) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (a tree of tensors, or of
    anything with a ``shape``): leaves take the checkpoint's dtype and
    go to ``device`` (default: the ``like`` leaf's device, else the
    CPU). Returns (tree, step); raises on a shape mismatch."""
    root = pathlib.Path(path)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = root / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())["leaves"]
    out = []
    for key, like_leaf in tree_lib.keyed(like).items():
        meta = manifest[key]
        t = _from_numpy(np.load(d / meta["file"]), meta)
        want = tuple(getattr(like_leaf, "shape", t.shape))
        if tuple(t.shape) != want:
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != "
                             f"{want}")
        dev = device if device is not None else getattr(like_leaf, "device",
                                                        "cpu")
        out.append(t.to(dev))
    return tree_lib.unflatten_like(like, iter(out)), step


class AsyncCheckpointer:
    """Overlap checkpoint I/O with training: ``save`` copies the tree to
    host memory (synchronously: the caller may then update the tensors
    in place) and writes it from a background thread, keeping the newest
    ``keep`` steps. ``wait()`` before exit or the next save."""

    def __init__(self, path, keep: int = 3):
        self.path = pathlib.Path(path)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        host_tree = tree_lib.map(
            lambda x: torch.as_tensor(x).detach().to("cpu", copy=True), tree)

        def _write():
            try:
                save(self.path, step, host_tree)
                self._gc()
            except BaseException as err:        # raised by wait()
                self._error = err

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; re-raise its error, if it had one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(d for d in self.path.iterdir()
                       if d.name.startswith("step_"))
        for d in steps[:-self.keep]:
            shutil.rmtree(d, ignore_errors=True)
