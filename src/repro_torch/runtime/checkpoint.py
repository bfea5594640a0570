"""Fault-tolerant checkpointing: atomic writes, keep-k retention, an async
save thread, auto-resume.

Format (the JAX package's, so either package reads the other's files):
one ``step_%010d.npz`` per checkpoint holding every leaf under its tree
path (dict keys and list / tuple indices joined by ``/``, as
``jax.tree_util.tree_flatten_with_path`` names them), plus a JSON sidecar
with the step, the time, each entry's dtype and the caller's metadata.
bfloat16 has no numpy dtype, so a bf16 leaf is stored as its ``uint16``
bits and tagged ``"bfloat16"`` in the sidecar.  Writes go to a temporary
name and are published by ``os.replace``: a crash mid-save never corrupts
the latest checkpoint, and a restart resumes from the newest *complete*
one (payload and sidecar both present).

Leaves may be torch tensors on any device, numpy arrays or Python
scalars; a save gathers them to the host, a restore gives each leaf the
type, dtype and device of the template's leaf at the same path.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

PyTree = Any

_STEP_RE = re.compile(r"step_(\d+)\.npz$")


def _paths(tree: PyTree, prefix: Tuple[str, ...] = ()):
    """``(path, leaf)`` pairs of a tree of dicts (keys in sorted order, as
    jax flattens them), lists and tuples; ``None`` is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _host(leaf, copy: bool = False):
    """A leaf on the host: a numpy array, or a CPU bfloat16 tensor (numpy
    has no bfloat16).  ``copy`` takes a private copy even of host data, so
    a later in-place write by the caller cannot reach it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.to("cpu", copy=copy)
        return t.to("cpu", copy=copy).numpy()
    return np.array(leaf, copy=copy) if copy else np.asarray(leaf)


def _flatten(tree: PyTree) -> Dict[str, Any]:
    return {k: _host(v) for k, v in _paths(tree)}


def _map_tree(tree: PyTree, fn, prefix: Tuple[str, ...] = ()) -> PyTree:
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_tree(v, fn, prefix + (str(i),))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    if tree is None:
        return None
    return fn("/".join(prefix), tree)


def _as_leaf(arr, like):
    """``arr`` (numpy, or a CPU bf16 tensor) as the template leaf ``like``:
    a tensor of its dtype on its device, or a numpy array of its dtype."""
    if isinstance(like, torch.Tensor):
        t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(arr)
        return t.to(device=like.device, dtype=like.dtype)
    want = getattr(like, "dtype", None)
    if isinstance(arr, torch.Tensor):
        if want is None:
            return arr
        arr = arr.float().numpy()
    if want is not None and arr.dtype != want:
        arr = arr.astype(want)
    return arr


def _unflatten(template: PyTree, arrays: Dict[str, Any]) -> PyTree:
    return _map_tree(template, lambda k, leaf: _as_leaf(arrays[k], leaf))


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    async_save: bool = False

    def __post_init__(self):
        if self.keep < 1:
            raise ValueError(f"keep must be >= 1, got {self.keep}")
        self.dir = Path(self.directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---- save -----------------------------------------------------------
    def save(self, step: int, state: PyTree,
             metadata: Optional[Dict] = None) -> Path:
        if self.async_save:
            self.wait()  # one in flight at a time; re-raises a failed save
            # the host copy is taken now: the caller may overwrite or free
            # its tensors while the write runs
            host_state = _map_tree(state, lambda _, v: _host(v, copy=True))
            self._thread = threading.Thread(
                target=self._save_guarded,
                args=(step, host_state, metadata))
            self._thread.start()
            return self._path(step)
        return self._save_sync(step, state, metadata)

    def _save_guarded(self, step: int, state: PyTree,
                      metadata: Optional[Dict]) -> None:
        """Thread target: keep the exception instead of dying silently on
        the save thread; ``wait()`` / the next ``save()`` re-raise it."""
        try:
            self._save_sync(step, state, metadata)
        except BaseException as e:       # noqa: BLE001 -- surfaced later
            self._error = e

    def _save_sync(self, step: int, state: PyTree,
                   metadata: Optional[Dict]) -> Path:
        final = self._path(step)
        tmp = final.with_suffix(".tmp.npz")
        packed = {}
        dtypes = {}
        for k, v in _flatten(state).items():
            if isinstance(v, torch.Tensor):       # bfloat16: its bits
                packed[k] = v.view(torch.int16).numpy().view(np.uint16)
                dtypes[k] = "bfloat16"
            else:
                packed[k] = v
                dtypes[k] = str(v.dtype)
        np.savez(tmp, **packed)
        meta = {"step": int(step), "time": time.time(),
                "dtypes": dtypes, **(metadata or {})}
        tmp_meta = final.with_suffix(".tmp.json")
        tmp_meta.write_text(json.dumps(meta))
        os.replace(tmp, final)                       # atomic publish
        os.replace(tmp_meta, final.with_suffix(".json"))
        self._gc()
        return final

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                "async checkpoint save failed; the checkpoint was NOT "
                "written") from err

    # ---- restore --------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*.npz"):
            m = _STEP_RE.search(p.name)
            if m and p.with_suffix(".json").exists():  # complete only
                out.append(int(m.group(1)))
        return sorted(out)

    def restore(self, template: PyTree, step: Optional[int] = None
                ) -> Tuple[int, PyTree]:
        implicit = step is None
        # an implicit restore retries once with a fresh listing: a
        # concurrent save's GC may have retired the step it first picked
        for attempt in (0, 1):
            s = self.latest_step() if implicit else step
            if s is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
            try:
                return s, self._read(s, template)
            except FileNotFoundError:
                if not implicit or attempt:
                    raise
        raise AssertionError("unreachable")

    def _read(self, step: int, template: PyTree) -> PyTree:
        final = self._path(step)
        meta = json.loads(final.with_suffix(".json").read_text())
        with np.load(final) as z:
            arrays = {}
            for k in z.files:
                v = z[k]
                if meta["dtypes"].get(k) == "bfloat16":
                    v = torch.from_numpy(v.view(np.int16)).view(
                        torch.bfloat16)
                arrays[k] = v
        return _unflatten(template, arrays)

    def metadata(self, step: Optional[int] = None) -> Dict:
        """The JSON sidecar of ``step`` (default: the newest complete
        checkpoint): step, time, dtypes and whatever ``save`` attached."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return json.loads(self._path(step).with_suffix(".json").read_text())

    # ---- retention ------------------------------------------------------
    def _gc(self):
        # ONE listing decides retention, and the newest complete step is
        # never deleted: a concurrent restore that just listed it can still
        # read it (besides restore's own implicit-step retry above)
        steps = self.all_steps()
        newest = steps[-1] if steps else None
        for s in steps[: max(len(steps) - self.keep, 0)]:
            if s == newest:
                continue
            # sidecar first: the step turns "incomplete" (invisible to
            # all_steps / latest_step) before its payload disappears
            self._path(s).with_suffix(".json").unlink(missing_ok=True)
            self._path(s).unlink(missing_ok=True)

    def _path(self, step: int) -> Path:
        return self.dir / f"step_{step:010d}.npz"


def resume_or_init(mgr: CheckpointManager, init_fn: Callable[[], PyTree]
                   ) -> Tuple[int, PyTree]:
    """Auto-resume: the newest complete checkpoint, else a fresh init at
    step 0."""
    if mgr.latest_step() is not None:
        return mgr.restore(init_fn())
    return 0, init_fn()
