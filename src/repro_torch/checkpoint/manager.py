"""Fault-tolerant checkpointing — the port of
``repro/checkpoint/manager.py``.

  * **atomic**: writes go to ``step_XXXXXXXX.tmp/`` and are renamed into
    place only after the manifest is fsynced — a crash mid-write never
    corrupts the latest good checkpoint.
  * **device-free**: arrays are stored whole on the host, and ``restore``
    places each on its template leaf's device, so a state written from
    the GPU restores onto the CPU and the other way round.
  * **async**: ``save_async`` copies the state to host memory
    synchronously (the train loop then updates its tensors in place) and
    writes it to disk on a background thread.
  * **retention**: keep the last N checkpoints.

A state is a tree of dicts, lists and tuples whose leaves are tensors,
NumPy arrays or numbers.  npz has no bfloat16, so a bfloat16 leaf is
stored as its uint16 view and its dtype is kept in the manifest.
Arrays are stored under their index in the manifest's ``keys`` (a
parameter name holds dots, which npz names cannot carry through).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten_into(template, flat, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], flat, f"{prefix}{k}/")
                for k in template}
    if isinstance(template, tuple):
        return tuple(_unflatten_into(v, flat, f"{prefix}{i}/")
                     for i, v in enumerate(template))
    if isinstance(template, list):
        return [_unflatten_into(v, flat, f"{prefix}{i}/")
                for i, v in enumerate(template)]
    return _place(flat[prefix[:-1]], template, prefix[:-1])


def _to_host(v) -> tuple[np.ndarray, str]:
    """A host copy of a leaf that later in-place updates cannot reach,
    and its dtype's name (bfloat16 as its uint16 view)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.array(v)
    return a, str(a.dtype)


def _place(a, template, key: str):
    """A stored array (a bfloat16 one as a tensor) in the form of its
    template leaf: a tensor on the template's device, a NumPy array, or
    a Python number."""
    if tuple(np.shape(template)) != tuple(a.shape):
        raise ValueError(f"checkpoint leaf {key!r} has shape "
                         f"{tuple(a.shape)}, the template "
                         f"{tuple(np.shape(template))}")
    if isinstance(template, torch.Tensor):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(a)
        return a.to(template.device)
    if isinstance(template, np.ndarray):
        return a
    return type(template)(a.item())


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, extra: dict | None = None):
        """Synchronous atomic save."""
        self._write(step, self._snapshot(state), extra or {})

    def save_async(self, step: int, state: Any, extra: dict | None = None):
        """Snapshot now, write on a background thread."""
        self.wait()
        host = self._snapshot(state)
        self._thread = threading.Thread(
            target=self._write, args=(step, host, extra or {}), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @staticmethod
    def _snapshot(state) -> dict:
        return {k: _to_host(v) for k, v in _flatten(state).items()}

    def _write(self, step: int, host: dict, extra: dict):
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        keys = sorted(host)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": host[k][0] for i, k in enumerate(keys)})
        manifest = {
            "step": step,
            "keys": keys,
            "dtypes": {k: host[k][1] for k in keys},
            "shapes": {k: list(host[k][0].shape) for k in keys},
            "extra": extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: int | None = None):
        """Restore into the structure of ``template`` (the latest step by
        default) -> (state, extra, step).  Each leaf takes its template
        leaf's form: a tensor on the template's device, a NumPy array
        or a number; a leaf of another shape raises ``ValueError``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[f"a{i}"] for i, k in enumerate(manifest["keys"])}
        for k, dt in manifest["dtypes"].items():
            if dt == "bfloat16":
                flat[k] = torch.from_numpy(flat[k].view(np.int16)).view(
                    torch.bfloat16)
        return _unflatten_into(template, flat), manifest["extra"], step
