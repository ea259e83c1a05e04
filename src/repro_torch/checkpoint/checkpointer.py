"""Checkpointing: atomic, manifest-driven, async-capable, resume-exact.

Layout per step:  <dir>/step_<N>/  { manifest.json, arrays.npz }

* save writes to a temporary directory and renames it into place, so a
  crashed save cannot corrupt the latest checkpoint, and the next
  Checkpointer on the directory removes what a crash left behind;
* ``async_save`` copies every leaf to the host synchronously (cheap) and
  writes the file in a worker thread; a failed write re-raises from
  ``wait()`` (or the next save);
* transient write failures are retried with exponential backoff, each
  retry counted in ``n_retries``;
* ``keep`` rotates old checkpoints;
* the manifest records each leaf's path, dtype and byte length and the
  leaf count, and ``restore`` refuses a truncated or corrupted archive as
  ``CheckpointCorruptError``.

A state is a tree of dicts (sorted keys), lists and tuples (NamedTuples
included) whose leaves are torch tensors or numpy arrays.  numpy has no
bfloat16 without ``ml_dtypes``, so a bfloat16 tensor is stored as its
int16 bit view and restored, from the dtype its manifest names, bit for
bit as torch.bfloat16.  ``restore`` gives each leaf the dtype it was saved
with (not the template's), so a caller can check it against its own.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


class CheckpointCorruptError(RuntimeError):
    """A checkpoint on disk is truncated or corrupted (bad zip or CRC, a
    leaf count or byte length disagreeing with the manifest): restore
    refuses it loudly instead of loading damaged state."""


def flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """Depth-first (path, leaf) pairs; dicts in sorted-key order, lists and
    tuples by index."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten(v, f"{prefix}{i}/")
        return out
    return [(prefix[:-1], tree)]


def unflatten(template, leaves):
    """``template``'s tree with its leaves replaced, in ``flatten`` order,
    by ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            kids = [build(v) for v in t]
            if isinstance(t, list):
                return kids
            return type(t)(*kids) if hasattr(t, "_fields") else tuple(kids)
        return next(it)

    return build(template)


def dtype_name(leaf) -> str:
    """A leaf's dtype as the manifest names it ("float32", "bfloat16",
    "int32", "bool", ...)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return np.asarray(leaf).dtype.name


def to_host(leaf) -> np.ndarray:
    """A copy of a leaf as a host numpy array (a bfloat16 tensor as its
    int16 bits), so the caller may change the leaf afterwards."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return np.array(t.cpu().numpy())
    return np.array(leaf)


def from_host(arr: np.ndarray, name: str, like):
    """The stored array as a leaf of the dtype ``name`` it was saved with: a
    tensor on ``like``'s device when the template leaf is a tensor, else a
    numpy array."""
    if isinstance(like, torch.Tensor):
        # an array np.load just read owns its memory: no copy needed
        t = torch.from_numpy(arr if arr.flags.writeable else np.array(arr))
        if name == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(like.device)
    if name == "bfloat16":
        raise ValueError("a bfloat16 leaf needs a torch.Tensor template leaf "
                         "(numpy has no bfloat16)")
    return np.asarray(arr)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 retry_attempts: int = 3, retry_backoff_s: float = 0.05):
        self.dir = directory
        self.keep = keep
        # transient write failures get retry_attempts tries with
        # exponential backoff before the save is declared dead; n_retries
        # counts every retried failure, so flakiness that never became an
        # error still shows
        self.retry_attempts = max(1, int(retry_attempts))
        self.retry_backoff_s = float(retry_backoff_s)
        self.n_retries = 0
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # anything still named .tmp_step_* was never renamed into place, so
        # it is no checkpoint: reclaim the disk rather than accrete orphans
        for d in os.listdir(directory):
            if d.startswith(".tmp_step_"):
                shutil.rmtree(os.path.join(directory, d), ignore_errors=True)

    # -- save ----------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any], blocking: bool = True):
        """Write ``state`` (a tree of tensors and arrays) as step ``step``.
        The leaves are copied to the host before this returns, so the
        caller may go on changing its tensors while an async write runs."""
        self.wait()
        pairs = flatten(state)
        flat = {f"a{i}": to_host(v) for i, (_, v) in enumerate(pairs)}
        manifest = {"step": step, "paths": [p for p, _ in pairs],
                    "n_leaves": len(pairs),
                    "dtypes": [dtype_name(v) for _, v in pairs],
                    "nbytes": [int(flat[f"a{i}"].nbytes)
                               for i in range(len(pairs))]}
        tmp = os.path.join(self.dir, f".tmp_step_{step}")

        def write_once():
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._rotate()

        def write():
            for attempt in range(self.retry_attempts):
                try:
                    write_once()
                    return
                except Exception:       # noqa: BLE001
                    # a partial arrays.npz must never survive into a retry
                    shutil.rmtree(tmp, ignore_errors=True)
                    if attempt == self.retry_attempts - 1:
                        raise
                    self.n_retries += 1
                    time.sleep(self.retry_backoff_s * (2 ** attempt))

        if blocking:
            write()
            return

        def worker():
            # a failed async save must not be silent: keep the exception
            # for wait() or the next save()
            try:
                write()
            except BaseException as e:      # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def async_save(self, step: int, state: Dict[str, Any]):
        self.save(step, state, blocking=False)

    def wait(self):
        """Wait for an async save; re-raise its failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"async checkpoint save failed after {self.retry_attempts} "
                "attempts (the checkpoint was NOT written)") from err

    def _rotate(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def all_steps(self):
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Dict[str, Any], step: Optional[int] = None):
        """-> (state with ``template``'s tree, step).  Leaf paths are checked
        against the manifest; each leaf comes back with its saved dtype, as
        a tensor on the template leaf's device or as a numpy array, like the
        template leaf."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            raise
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            raise CheckpointCorruptError(
                f"unreadable manifest in {path}: {e}") from e
        try:
            arrays = np.load(os.path.join(path, "arrays.npz"))
        except (OSError, ValueError, zipfile.BadZipFile, EOFError) as e:
            raise CheckpointCorruptError(
                f"unreadable arrays.npz in {path} (truncated or corrupted "
                f"archive): {e}") from e
        tmpl_pairs = flatten(template)
        if [p for p, _ in tmpl_pairs] != manifest["paths"]:
            raise ValueError(
                "checkpoint/template tree mismatch:\n"
                f"  ckpt: {manifest['paths'][:5]}...\n"
                f"  tmpl: {[p for p, _ in tmpl_pairs][:5]}...")
        if len(arrays.files) != manifest["n_leaves"]:
            raise CheckpointCorruptError(
                f"checkpoint {path} truncated: manifest promises "
                f"{manifest['n_leaves']} leaves, archive holds "
                f"{len(arrays.files)}")
        leaves = []
        for i, (_, tmpl) in enumerate(tmpl_pairs):
            try:
                # npz members are CRC-checked by zipfile on read, so a
                # flipped bit surfaces here
                arr = arrays[f"a{i}"]
            except Exception as e:     # noqa: BLE001  (BadZipFile, zlib, Key)
                raise CheckpointCorruptError(
                    f"leaf a{i} of {path} is unreadable (corrupted archive "
                    f"member): {e}") from e
            if int(arr.nbytes) != int(manifest["nbytes"][i]):
                raise CheckpointCorruptError(
                    f"leaf a{i} of {path} has {arr.nbytes} bytes, manifest "
                    f"promises {manifest['nbytes'][i]}: truncated or damaged")
            leaves.append(from_host(arr, manifest["dtypes"][i], tmpl))
        return unflatten(template, leaves), step
