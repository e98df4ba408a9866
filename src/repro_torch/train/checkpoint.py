"""Atomic checkpointing, with the reference's on-disk layout.

* **atomic**: a step is written into ``step_XXXXXXXXXX.tmp/``, each payload
  fsynced, then ``manifest.json`` (written last, fsynced), the directory
  fsynced, renamed into place and the rename fsynced in the parent. A crash
  at any point leaves the previous checkpoint or this one, and a partial
  directory is ignored.
* **keep-k**: completed checkpoints beyond ``keep`` are deleted oldest
  first.
* **logical arrays**: one ``.npy`` per flattened tree path, gathered to the
  host (``.cpu().numpy()``), never a device layout; a restore puts each leaf
  on the device it is asked for. A checkpoint written by the JAX package
  restores here, and the reverse.

Restored uint32 leaves come back as int32 tensors holding the same bits
(the port's convention for packed bitsets and label rows: PyTorch has few
uint32 operations). ``shardings=`` places leaves on a device mesh as
DTensors (the ``(mesh, placements)`` pairs of ``dist.bind_shardings``);
every rank of the mesh makes the same restore call.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Iterable, Optional

import numpy as np
import torch

from ..utils import resolve_device


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}.{k}" if prefix else k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}.{i}" if prefix else str(i)))
    else:
        out[prefix] = tree
    return out


def _flatten_like(tree, template, prefix=""):
    """``tree``'s entries at ``template``'s leaves, by path: a sharding leaf
    is itself a ``(mesh, placements)`` pair, so the template says where the
    leaves are."""
    if isinstance(template, dict):
        out = {}
        for k, v in template.items():
            out.update(_flatten_like(tree[k], v, f"{prefix}.{k}" if prefix else k))
        return out
    if isinstance(template, (list, tuple)):
        out = {}
        for i, v in enumerate(template):
            out.update(_flatten_like(tree[i], v, f"{prefix}.{i}" if prefix else str(i)))
        return out
    return {prefix: tree}


def _unflatten(flat: dict, template):
    def rec(t, prefix=""):
        if isinstance(t, dict):
            return {k: rec(v, f"{prefix}.{k}" if prefix else k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            vals = [rec(v, f"{prefix}.{i}" if prefix else str(i)) for i, v in enumerate(t)]
            return type(t)(vals)
        return flat[prefix]
    return rec(template)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- write ---------------------------------------------------------------
    @staticmethod
    def _fsync_dir(path: str) -> None:
        """Flush a directory's entries (file creations, the rename) to disk:
        without it a power loss can forget a file that was itself fsynced."""
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def save(self, step: int, state: dict, extra: Optional[dict] = None) -> str:
        """Durable on return: every payload ``.npy`` and the manifest are
        fsynced, then the tmp directory's entries, then the rename in the
        parent. A step already completed is left as it is."""
        name = f"step_{step:010d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        if os.path.exists(os.path.join(final, "manifest.json")):
            return final
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = _flatten(state)
        for path, leaf in flat.items():
            with open(os.path.join(tmp, path + ".npy"), "wb") as f:
                np.save(f, _host(leaf))
                f.flush()
                os.fsync(f.fileno())
        manifest = {
            "step": step,
            "time": time.time(),
            "paths": sorted(flat.keys()),
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        self._fsync_dir(tmp)
        os.replace(tmp, final)
        self._fsync_dir(self.dir)
        self._gc()
        return final

    def _gc(self):
        done = self.completed_steps()
        for step in done[: max(0, len(done) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{step:010d}"), ignore_errors=True)

    # -- read ----------------------------------------------------------------
    def completed_steps(self) -> list[int]:
        out = []
        for d in sorted(os.listdir(self.dir)):
            full = os.path.join(self.dir, d)
            if d.startswith("step_") and not d.endswith(".tmp") and \
                    os.path.exists(os.path.join(full, "manifest.json")):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.completed_steps()
        return steps[-1] if steps else None

    def manifest(self, step: Optional[int] = None) -> dict:
        """The manifest of a completed step: its paths and the ``extra``
        recorded at save time (the live index's static configuration)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no completed checkpoint in {self.dir}")
        with open(os.path.join(self.dir, f"step_{step:010d}", "manifest.json")) as f:
            return json.load(f)

    def restore_flat(self, step: Optional[int] = None, shardings: Optional[dict] = None,
                     mmap: Optional[Iterable[str]] = None, *,
                     device="cuda") -> tuple[dict, dict]:
        """Template-free restore: ``({path: leaf}, manifest)``. Each leaf is
        a tensor on ``device``, except the leaves named in ``mmap``: those
        are copy-on-write memory-mapped numpy arrays (a tiered corpus's host
        store restores so, and its raw rows never reach the card).
        ``shardings`` is an optional flat ``{path: (mesh, placements)}``
        dict: those leaves come back as DTensors laid out on the mesh."""
        dev = resolve_device(device)
        manifest = self.manifest(step)
        d = os.path.join(self.dir, f"step_{manifest['step']:010d}")
        mm = frozenset(mmap or ())
        flat = {}
        for path in manifest["paths"]:
            fp = os.path.join(d, path + ".npy")
            if path in mm:
                flat[path] = np.load(fp, mmap_mode="c")
                continue
            flat[path] = _tensor(np.load(fp), dev)
            bind = None if shardings is None else shardings.get(path)
            if bind is not None:
                from torch.distributed.tensor import distribute_tensor
                flat[path] = distribute_tensor(flat[path], *bind)
        return flat, manifest

    def restore(self, template, step: Optional[int] = None, shardings=None, *,
                device="cuda") -> tuple[dict, int]:
        """Load into ``template``'s structure, each leaf on ``device``, or
        laid out on a mesh where ``shardings`` (a tree of ``(mesh,
        placements)`` or None leaves matching ``template``) says so.
        Returns (state, step)."""
        flat_shard = None if shardings is None else _flatten_like(shardings, template)
        flat, manifest = self.restore_flat(step, flat_shard, device=device)
        return _unflatten(flat, template), manifest["step"]
