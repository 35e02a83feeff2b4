"""Atomic, hash-verified checkpoints of trees of tensors
(``repro.checkpoint.checkpoint`` counterpart), on the JAX package's
on-disk layout, so that either package restores what the other wrote:

    <dir>/step_00000123/
        manifest.json   leaf count, tree structure, per-leaf SHA1, dtype
                        (numpy's name: "float32", "bfloat16", ...) and shape
        arrays.npz      leaf_<i>: the leaf's bytes as a flat uint8 array
        _COMMITTED      written last

Leaves are numbered in JAX's flatten order (`repro_torch.core.tree`: dict
keys sorted, sequences in order).  bfloat16 goes in and out as a byte
view of the tensor (``view(torch.uint8)`` / ``view(torch.bfloat16)``),
the bytes numpy's ``ml_dtypes`` writes.

  * atomic: a save stages into ``step_X.tmp-<nonce>/`` and renames it;
    readers trust only directories holding ``_COMMITTED``, so a killed
    writer never corrupts what restore finds;
  * self-validating: each leaf's SHA1 is checked on restore;
  * the leaves are hashed, and read back, on a thread pool (file reads
    and hashlib release the GIL; each reader opens the archive itself);
  * restore places every leaf on ``device`` (one card has no mesh: this
    takes the place of the JAX package's ``shardings=``);
  * async: `AsyncCheckpointer` snapshots to host memory on the caller's
    thread and writes on a background thread.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import tree as T


def _dtype_name(t: torch.Tensor) -> str:
    """numpy's name of a torch dtype ("float32", "bfloat16", "int8")."""
    return str(t.dtype).removeprefix("torch.")


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"checkpoint dtype {name!r} has no torch dtype")
    return dt


def _host(leaf, copy: bool = False) -> torch.Tensor:
    """The leaf as a host tensor; ``copy`` forces a copy even on the
    host, so the caller may overwrite the leaf afterwards."""
    if not isinstance(leaf, torch.Tensor):
        return torch.as_tensor(np.asarray(leaf))
    return leaf.detach().to("cpu", copy=copy)


def _encode(t: torch.Tensor) -> np.ndarray:
    """The tensor's bytes as a flat uint8 array (npz has no bfloat16)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _decode(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    return torch.from_numpy(raw).view(_torch_dtype(dtype)).reshape(shape)


def _sha1(raw: np.ndarray) -> str:
    return hashlib.sha1(memoryview(np.ascontiguousarray(raw))).hexdigest()


def _parallel(fn, items) -> list:
    """``[fn(x) for x in items]`` on a thread pool."""
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        return list(pool.map(fn, items))


def _step_dir(ckpt_dir, step: int) -> Path:
    return Path(ckpt_dir) / f"step_{step:08d}"


def save(ckpt_dir: str | Path, step: int, tree: Any,
         extra: dict | None = None) -> Path:
    """Synchronous atomic checkpoint of a tree of tensors; returns the
    step directory."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = Path(tempfile.mkdtemp(prefix=final.name + ".tmp-", dir=ckpt_dir))
    try:
        leaves = T.leaves(tree)
        arrays, dtypes, shapes = {}, {}, {}
        for i, leaf in enumerate(leaves):
            t = _host(leaf)
            key = f"leaf_{i}"
            dtypes[key] = _dtype_name(t)
            shapes[key] = list(t.shape)
            arrays[key] = _encode(t)
        hashes = dict(zip(arrays, _parallel(_sha1, arrays.values())))
        np.savez(tmp / "arrays.npz", **arrays)
        manifest = {"step": step, "n_leaves": len(leaves),
                    "treedef": f"PyTreeDef({T.structure(tree)})",
                    "hashes": hashes, "dtypes": dtypes, "shapes": shapes,
                    "extra": extra or {}}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        (tmp / "_COMMITTED").write_text("ok")
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _committed_steps(ckpt_dir: Path):
    if not ckpt_dir.exists():
        return []
    return [int(d.name.split("_")[1]) for d in ckpt_dir.iterdir()
            if d.is_dir() and d.name.startswith("step_")
            and ".tmp-" not in d.name and (d / "_COMMITTED").exists()]


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    """Highest COMMITTED step, ignoring torn or partial writes."""
    return max(_committed_steps(Path(ckpt_dir)), default=None)


def restore(ckpt_dir: str | Path, step: int, like: Any, device=None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors, ``meta``
    ones included): each leaf hash-checked, cast to its target's dtype
    and placed on ``device`` (default: its target's device)."""
    d = _step_dir(ckpt_dir, step)
    if not (d / "_COMMITTED").exists():
        raise FileNotFoundError(f"no committed checkpoint at {d}")
    manifest = json.loads((d / "manifest.json").read_text())
    targets = T.leaves(like)
    if manifest["n_leaves"] != len(targets):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, target structure "
            f"has {len(targets)} — refusing to restore")
    keys = [f"leaf_{i}" for i in range(len(targets))]

    def read(key):
        with np.load(d / "arrays.npz") as data:
            raw = data[key]
        if _sha1(raw) != manifest["hashes"][key]:
            raise IOError(f"checkpoint corruption detected in {key}")
        return raw
    raws = _parallel(read, keys)
    out = []
    for key, raw, tgt in zip(keys, raws, targets):
        t = _decode(raw, manifest["dtypes"][key], manifest["shapes"][key])
        if tuple(t.shape) != tuple(tgt.shape):
            raise ValueError(f"{key}: saved {tuple(t.shape)} != target "
                             f"{tuple(tgt.shape)}")
        out.append(t.to(device=device if device is not None
                        else tgt.device, dtype=tgt.dtype))
    return T.unflatten(like, out)


def restore_extra(ckpt_dir: str | Path, step: int) -> dict:
    d = _step_dir(ckpt_dir, step)
    return json.loads((d / "manifest.json").read_text())["extra"]


class AsyncCheckpointer:
    """Background-thread checkpointing: snapshot to host, write off the
    caller's thread, overlap with the next step.  One save in flight at a
    time (a second save waits: bounded host memory)."""

    def __init__(self, ckpt_dir: str | Path):
        self.ckpt_dir = Path(ckpt_dir)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra: dict | None = None):
        self.wait()
        # the snapshot is taken on the caller's thread, so the training
        # loop may replace or overwrite its tensors right after
        host_tree = T.tree_map(lambda x: _host(x, copy=True), tree)

        def _run():
            try:
                save(self.ckpt_dir, step, host_tree, extra)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def prune_old(ckpt_dir: str | Path, keep: int = 3):
    """Keep the newest ``keep`` committed checkpoints."""
    ckpt_dir = Path(ckpt_dir)
    for s in sorted(_committed_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)
