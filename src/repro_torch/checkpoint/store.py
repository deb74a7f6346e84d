"""Checkpoints with atomic renames and async writes, on numpy.

The port's own copy of the JAX package's ``checkpoint/store.py`` (which
imports ``jax`` and ``ml_dtypes``), writing and reading the same on-disk
layout, so each package restores the other's checkpoints:

  * **Layout.** ``step_N/`` holds ``index.json`` — ``step`` and
    ``leaves``: key → ``file``, ``shape``, ``dtype`` and ``crc`` (the
    first 16 hex digits of the md5 of the array's bytes) — and one
    ``leaf_NNNNN.npy`` per leaf, numbered in sorted-key order.  Nested
    dicts flatten to ``a/b`` keys, list and tuple items to their index.
  * **Atomicity.** A step is written as ``step_N.tmp-<pid>`` and
    published by ``os.rename``; readers never see partial state.  An
    existing ``step_N`` is renamed aside to ``step_N.old-<pid>`` first
    and deleted only after the publish, so a crash in between leaves a
    copy that the next store's open renames back.
  * **Async.** ``save(..., blocking=False)`` copies to host memory and
    hands the copy to a writer thread.  A failed write is latched and
    raised by the next ``save``, ``wait`` or ``close``.
  * **Retention.** The ``keep`` newest steps stay; older ones, and the
    tmp/old directories a killed writer left, are collected after a
    successful write (never before).

``restore(step, like=None)`` returns the flat dict, or with ``like`` (a
tree of nested dicts, lists and tuples whose leaves are tensors or
arrays) that tree rebuilt from the flat keys: each tensor leaf on its
``like`` leaf's device and in its dtype, each array leaf as an array of
its dtype, as the JAX store's ``restore(like=)`` does; a leaf whose
shape is not its ``like`` leaf's is refused, so a run resumes only from
its own model's state.  A training state
``(params, opt_state)`` saved by either package restores in the other.

Differences from the JAX store: no ``shardings=`` (the port has no mesh
for the LM), ``save`` accepts torch tensors (copied to the host before
it returns, so a non-blocking save of tensors that are then updated in
place writes the values of the call), and a ``bfloat16`` or fp8 leaf is
refused with a ``TypeError`` naming its key, since numpy has no such
dtype without ``ml_dtypes``.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading

import numpy as np
import torch

from ..tree import tree_unflatten

__all__ = ["CheckpointStore", "save", "restore", "latest_step"]

_FLAT_SEP = "/"
# dtypes the JAX store writes through ml_dtypes as raw integer views
_CUSTOM_DTYPES = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


def _refuse(key: str, dtype) -> TypeError:
    return TypeError(
        f"checkpoint leaf {key!r} has dtype {dtype}: bfloat16/fp8 leaves need "
        f"ml_dtypes, which this store does not use")


def _host(key: str, v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        if v.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
            raise _refuse(key, v.dtype)
        t = v.detach()
        arr = t.cpu().numpy()
        return arr.copy() if t.device.type == "cpu" else arr  # never a view of a tensor updated later
    arr = np.asarray(v)
    if arr.dtype.kind == "V" or str(arr.dtype) in _CUSTOM_DTYPES:
        raise _refuse(key, arr.dtype)
    return arr


def _flatten(tree, prefix: str = "") -> dict:
    """Nested dicts/lists/tuples → {"a/b/0": leaf}; ``None`` is no leaf."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    elif tree is None:
        return {}
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{_FLAT_SEP}{k}" if prefix else str(k)))
    return out


def _crc(arr: np.ndarray) -> str:
    return hashlib.md5(arr.tobytes()).hexdigest()[:16]


def save(path: str, step: int, tree, *, blocking: bool = True, keep: int = 3):
    """One-shot save (see CheckpointStore for the managed API)."""
    store = CheckpointStore(path, keep=keep)
    store.save(step, tree, blocking=blocking)
    store.close()


def restore(path: str, step: int | None = None, like=None):
    store = CheckpointStore(path)
    try:
        return store.restore(step=step, like=like)
    finally:
        store.close()


def _leaf_like(arr: np.ndarray, like):
    """``arr`` cast to the ``like`` leaf's dtype and, for a tensor, put on
    its device."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(np.array(arr)).to(device=like.device, dtype=like.dtype)
    return np.asarray(arr).astype(np.asarray(like).dtype)


def _published_steps(path: str) -> list[int]:
    """Step numbers of PUBLISHED directories only: a bare ``step_N``.  The
    in-flight ``step_N.tmp-<pid>`` and doomed ``step_N.old-<pid>`` are
    never surfaced to readers."""
    steps = []
    for d in os.listdir(path):
        if not d.startswith("step_"):
            continue
        suffix = d.split("_", 1)[1]
        if suffix.isdigit():
            steps.append(int(suffix))
    return steps


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = _published_steps(path)
    return max(steps) if steps else None


class CheckpointStore:
    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        os.makedirs(path, exist_ok=True)
        self._recover_aside()
        self._q: queue.Queue = queue.Queue()
        self._err: Exception | None = None
        # one writer on disk at a time: blocking saves from the caller
        # thread must not interleave with the async writer's publish
        self._disk_lock = threading.Lock()
        self._thread = threading.Thread(target=self._writer, daemon=True)
        self._thread.start()

    # -- write ------------------------------------------------------------

    def save(self, step: int, tree, *, blocking: bool = True):
        """Copy to host memory now, write to disk now or in the writer
        thread.  A latched async failure is raised here first."""
        self._raise_latched()
        host = {k: _host(k, v) for k, v in _flatten(tree).items()}
        if blocking:
            with self._disk_lock:
                self._write(step, host)
        else:
            self._q.put((step, host))

    def _raise_latched(self):
        if self._err is not None:
            raise RuntimeError(f"checkpoint writer failed under {self.path}") from self._err

    def wait(self):
        self._q.join()
        self._raise_latched()

    def close(self):
        self._q.join()
        self._q.put(None)
        self._thread.join(timeout=30)
        self._raise_latched()

    def _recover_aside(self):
        """A writer killed between "rename old aside" and "publish new"
        leaves ``step_N.old-<pid>`` and no ``step_N``: rename it back
        before anything can collect it."""
        for d in sorted(os.listdir(self.path)):
            tag = d.split(".", 1)
            if len(tag) == 2 and tag[1].startswith("old-"):
                final = os.path.join(self.path, tag[0])
                if not os.path.exists(final):
                    os.rename(os.path.join(self.path, d), final)

    def _writer(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, host = item
            try:
                with self._disk_lock:
                    self._write(step, host)
            except Exception as e:  # surfaced on the next save()/wait()/close()
                if self._err is None:  # keep the FIRST failure
                    self._err = e
            finally:
                self._q.task_done()

    def _write(self, step: int, host: dict):
        final = os.path.join(self.path, f"step_{step}")
        tmp = final + f".tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        index = {"step": step, "leaves": {}}
        for i, (key, arr) in enumerate(sorted(host.items())):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            index["leaves"][key] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "crc": _crc(arr),
            }
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
        # the previous copy of this step survives until the new one is
        # published: rename it aside, publish, then delete it
        doomed = None
        if os.path.exists(final):
            doomed = final + f".old-{os.getpid()}"
            if os.path.exists(doomed):  # leftover from a previous crash
                shutil.rmtree(doomed)
            os.rename(final, doomed)
        os.rename(tmp, final)  # atomic publish
        if doomed is not None:
            shutil.rmtree(doomed)
        self._gc()

    def _gc(self):
        steps = sorted(_published_steps(self.path))
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.path, f"step_{s}"), ignore_errors=True)
        # tmp/old directories of a KILLED writer (ours are cleaned inline
        # under _disk_lock): invisible to readers, junk
        for d in os.listdir(self.path):
            if not d.startswith("step_"):
                continue
            tag = d.split(".", 1)
            if len(tag) == 2 and (tag[1].startswith("tmp-") or tag[1].startswith("old-")):
                shutil.rmtree(os.path.join(self.path, d), ignore_errors=True)

    # -- read -------------------------------------------------------------

    def restore(self, step: int | None = None, like=None) -> tuple[int, dict]:
        """Returns (step, {key: array}), the newest published step when
        ``step`` is None, or (step, tree) in ``like``'s structure (see the
        module docstring).  Raises ``IOError`` on a checksum mismatch and
        ``KeyError`` when the checkpoint lacks a leaf of ``like`` and
        ``ValueError`` when a leaf's shape is not its ``like`` leaf's."""
        if step is None:
            step = latest_step(self.path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.path}")
        d = os.path.join(self.path, f"step_{step}")
        with open(os.path.join(d, "index.json")) as f:
            index = json.load(f)
        by_key = {}
        for key, meta in index["leaves"].items():
            if meta["dtype"] in _CUSTOM_DTYPES:
                raise _refuse(key, meta["dtype"])
            arr = np.load(os.path.join(d, meta["file"]))
            if _crc(arr) != meta["crc"]:
                raise IOError(f"checksum mismatch for {key} in step {step}")
            by_key[key] = arr
        if like is None:
            return step, by_key
        flat_like = _flatten(like)
        missing = set(flat_like) - set(by_key)
        if missing:
            raise KeyError(f"checkpoint missing leaves: {sorted(missing)[:5]}")
        wrong = [k for k, v in flat_like.items() if tuple(np.shape(v)) != by_key[k].shape]
        if wrong:
            raise ValueError(f"checkpoint leaves of another shape than like's: "
                             f"{[(k, by_key[k].shape, tuple(np.shape(flat_like[k]))) for k in wrong[:5]]}")
        return step, tree_unflatten(like, [_leaf_like(by_key[k], v) for k, v in flat_like.items()])
