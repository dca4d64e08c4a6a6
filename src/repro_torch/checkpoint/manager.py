"""Step-atomic checkpointing with async writes and auto-resume, in the
reference's on-disk layout.  Port of `repro.checkpoint.manager`.

Layout (the same bytes either package writes and reads):
  * ``step_XXXXXXXX/`` per step, one ``.npy`` per leaf named by its tree
    path with ``/`` as ``__`` (``params__0.npy``, ``opt__m__0.npy``), and
    a ``MANIFEST.json`` listing the leaf keys — the keys
    `jax.tree_util.tree_flatten_with_path` gives (list index, dict key,
    NamedTuple field: ``params/0``, ``opt/step``, ``opt/m/0``);
  * bf16 leaves are stored as f32 and restored as bf16;
  * atomicity: leaves land in ``step_XXXXXXXX.tmp/`` and one POSIX rename
    publishes the step; a crashed writer leaves only ``.tmp``, which is
    never resumed and is swept by the next save;
  * async: a writer thread drains a bounded queue of host snapshots;
    `wait()` drains it and raises the first write error; a blocking save
    first drains the queue, so writes never overlap (the reference's
    blocking save can run beside the writer thread, and two writes of
    one step — the loop's periodic save and its final one — then sweep
    each other's ``.tmp``);
  * `max_to_keep` newest complete steps are kept.

Leaves are torch tensors (any device) or numpy arrays; `restore` places
each leaf on its target leaf's device.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading

import numpy as np
import torch


def _children(node):
    """(key, child) pairs in `jax.tree` order, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(node)]
    return None


def _flatten_with_paths(tree, prefix: str = "") -> dict:
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for key, child in kids:
        out.update(_flatten_with_paths(child,
                                       f"{prefix}/{key}" if prefix else key))
    return out


def _unflatten(target, leaves: dict, prefix: str = ""):
    kids = _children(target)
    if kids is None:
        return leaves[prefix]
    built = {k: _unflatten(c, leaves, f"{prefix}/{k}" if prefix else k)
             for k, c in kids}
    if isinstance(target, dict):
        return {k: built[str(k)] for k in target}
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return type(target)(*(built[f] for f in target._fields))
    seq = [built[str(i)] for i in range(len(target))]
    return type(target)(seq) if isinstance(target, tuple) else seq


def _host(leaf) -> np.ndarray:
    """A leaf as a host array; bf16 as f32 (npy has no bf16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy()
    a = np.asarray(leaf)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_writes: bool = True, queue_size: int = 2):
        self.dir = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)
        self._q: queue.Queue = queue.Queue(maxsize=queue_size)
        self._errors: list = []
        self._thread = None
        if async_writes:
            self._thread = threading.Thread(target=self._writer, daemon=True)
            self._thread.start()

    # -- public API ----------------------------------------------------------

    def save(self, step: int, tree, blocking: bool = False):
        """Snapshot to host memory now; write in the background (or now,
        when `blocking` or the manager has no writer thread, after the
        writes queued before it)."""
        host = {k: _host(v) for k, v in _flatten_with_paths(tree).items()}
        if self._thread is None or blocking:
            if self._thread is not None:
                self._q.join()
            self._write(step, host)
        else:
            self._q.put((step, host))      # blocks if writer is behind

    def wait(self):
        if self._thread is not None:
            self._q.join()
        if self._errors:
            raise RuntimeError(f"checkpoint writer failed: {self._errors[0]}")

    def latest_step(self) -> int | None:
        steps = [int(d.split("_")[1]) for d in os.listdir(self.dir)
                 if d.startswith("step_") and not d.endswith(".tmp")
                 and os.path.exists(os.path.join(self.dir, d,
                                                 "MANIFEST.json"))]
        return max(steps) if steps else None

    def restore(self, step: int, target_tree):
        """Load every leaf of `target_tree`'s structure; each goes to its
        target leaf's device (the CPU for a non-tensor target), bf16
        where the target is bf16, else in the stored type."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        flat_target = _flatten_with_paths(target_tree)
        if set(manifest["leaves"]) != set(flat_target):
            raise ValueError("checkpoint/model structure mismatch: "
                             f"{sorted(manifest['leaves'])} against "
                             f"{sorted(flat_target)}")
        leaves = {}
        for key, ref in flat_target.items():
            t = torch.from_numpy(np.load(os.path.join(d, _fname(key))))
            dev = ref.device if isinstance(ref, torch.Tensor) else "cpu"
            if isinstance(ref, torch.Tensor) and ref.dtype == torch.bfloat16:
                t = t.to(torch.bfloat16)
            leaves[key] = t.to(dev)
        return _unflatten(target_tree, leaves)

    def restore_latest(self, target_tree):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target_tree)

    # -- internals -----------------------------------------------------------

    def _writer(self):
        while True:
            step, host = self._q.get()
            try:
                self._write(step, host)
            except Exception as e:  # surfaced on wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _write(self, step: int, host: dict):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        # sweep stale .tmp directories from crashed writers — every step;
        # a .tmp is by contract incomplete, never restored from
        for d in os.listdir(self.dir):
            if d.startswith("step_") and d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)
        os.makedirs(tmp)
        for key, arr in host.items():
            np.save(os.path.join(tmp, _fname(key)), arr)
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump({"step": step, "leaves": sorted(host)}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.dir)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)


def _fname(key: str) -> str:
    return key.replace("/", "__") + ".npy"
