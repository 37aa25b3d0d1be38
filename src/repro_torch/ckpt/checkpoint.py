"""Checkpoints of the port: npz payloads + JSON manifest, async save.

The port's twin of ``repro/ckpt/checkpoint.py``, with the same layout::

  <dir>/step_<N>/manifest.json   step, leaf paths/shapes/dtypes, extras
  <dir>/step_<N>/arrays.npz      one entry per leaf, "<tree>::<path>"
  <dir>/LATEST                   pointer to the newest step

``save`` copies every tensor to the host at once and writes the files in
a background thread (or at once with ``blocking=True``); ``wait()`` joins
before the next save, so at most one write is in flight; a DTensor leaf
is gathered whole first.  ``restore`` loads a step onto the device it
is given, or, with ``shardings=`` (``launch.sharding.Sharding`` trees by
tree name: ``runtime.elastic.plan_remesh``'s), onto placements: each
rank moves its own slice of a leaf to the device, as a DTensor.

Durability, as in the JAX package: ``arrays.npz``, ``manifest.json`` and
the step directory are fsync'd before ``LATEST`` flips; an existing step
is replaced by side-renames (``step_N`` -> ``step_N.trash``,
``step_N.tmp`` -> ``step_N``), never by a delete and a rename; ``LATEST``
is written through an fsync'd temporary file and ``os.replace``.  A kill
at any point leaves the previous step or the new one whole; stale
``.tmp``/``.trash`` residue is swept by the next save.  The ``ckpt.write``
fault site fires once the payload is durable under ``.tmp`` and before
it is published.  A background write's failure is kept and raised as
``CheckpointError`` by the next ``wait()`` or ``save()``, and counted in
``stats()['save_errors']``.

Leaves: tensors of any dtype, Python ints and floats (stored as 0-d
arrays and restored as Python numbers: a cache's ``index``), and
``kernels.pack.PackedWeights`` (each tensor field under its path, the
``bits``, ``k`` and ``n`` in the manifest).  numpy has no bfloat16: a
bf16 tensor is stored as its raw 16-bit words (int16) with ``bfloat16``
in the manifest and viewed back on restore, which is exact at half the
bytes of the JAX package's widening to float32.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import pack
from repro_torch.runtime import health

health.register_site("ckpt.write")

SEP = "/"


class CheckpointError(RuntimeError):
    """A checkpoint write failed (possibly asynchronously)."""


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    """(path, leaf) of every leaf; a ``PackedWeights`` yields its tensor
    fields under its path and itself under the path (for its sizes)."""
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, path + SEP)
        elif isinstance(val, pack.PackedWeights):
            yield path, val
            for f in val.LEAVES:
                if getattr(val, f) is not None:
                    yield f"{path}{SEP}{f}", getattr(val, f)
        else:
            yield path, val


def _to_host(leaf) -> Tuple[np.ndarray, Dict[str, Any]]:
    """A leaf as a numpy array and its manifest entry."""
    if hasattr(leaf, "full_tensor"):          # a DTensor: gathered whole
        leaf = leaf.full_tensor()
    if isinstance(leaf, bool) or not isinstance(leaf, (int, float,
                                                       torch.Tensor)):
        raise TypeError(f"cannot checkpoint a leaf of type "
                        f"{type(leaf).__name__}")
    if not torch.is_tensor(leaf):
        kind = "int" if isinstance(leaf, int) else "float"
        arr = np.asarray(leaf, np.int64 if kind == "int" else np.float64)
        return arr, {"shape": [], "dtype": kind, "kind": kind}
    host = leaf.detach().to("cpu", copy=True).contiguous()
    dtype = str(host.dtype).replace("torch.", "")
    if host.dtype == torch.bfloat16:
        arr = host.view(torch.int16).numpy()
    else:
        arr = host.numpy()
    return arr, {"shape": list(host.shape), "dtype": dtype, "kind": "tensor"}


def _from_host(arr: np.ndarray, meta: Dict[str, Any], device,
               sharding=None):
    if meta["kind"] == "int":
        return int(arr)
    if meta["kind"] == "float":
        return float(arr)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if meta["dtype"] == "bfloat16":
        t = t.view(torch.bfloat16)
    want = getattr(torch, meta["dtype"])
    if t.dtype != want or list(t.shape) != list(meta["shape"]):
        raise CheckpointError(f"leaf stored as {t.dtype} {list(t.shape)}, "
                              f"manifest says {want} {meta['shape']}")
    if sharding is None:
        return t.to(device)
    from repro_torch.models import parallel

    return parallel.from_global(t, sharding.mesh, sharding.placements,
                                device=device)


def _fsync_path(path: str) -> None:
    """fsync a file or a directory by path."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._save_error: Optional[BaseException] = None
        self._stats = {"saves": 0, "save_errors": 0, "restores": 0,
                       "gc_removed": 0}
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------
    def save(self, step: int, state: Dict[str, Dict[str, Any]],
             extras: Optional[Dict] = None, blocking: bool = False) -> None:
        """``state``: a dict of trees (``{"params": ..., "cache": ...}``).

        Raises ``CheckpointError`` here if the previous background save
        failed; a failure of this save is raised at once when
        ``blocking``, else by the next ``wait()``/``save()``."""
        self.wait()
        arrays: Dict[str, np.ndarray] = {}
        manifest: Dict[str, Any] = {"step": step, "extras": extras or {},
                                    "trees": {}, "packed": {}}
        for name, tree in state.items():
            leaves, packed = {}, {}
            for path, leaf in _flatten(tree):
                if isinstance(leaf, pack.PackedWeights):
                    packed[path] = {"bits": leaf.bits, "k": leaf.k,
                                    "n": leaf.n}
                    continue
                arr, meta = _to_host(leaf)
                arrays[f"{name}::{path}"] = arr
                leaves[path] = meta
            manifest["trees"][name] = leaves
            manifest["packed"][name] = packed

        def _write():
            d = os.path.join(self.dir, f"step_{step:08d}")
            tmp = d + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=2)
                f.flush()
                os.fsync(f.fileno())
            _fsync_path(os.path.join(tmp, "arrays.npz"))
            _fsync_path(tmp)
            # the payload is durable under .tmp and not yet published: a
            # kill here must leave the previous step and LATEST whole
            health.maybe_inject("ckpt.write")
            trash = None
            if os.path.exists(d):
                trash = d + ".trash"
                if os.path.exists(trash):
                    shutil.rmtree(trash)
                os.rename(d, trash)
            os.rename(tmp, d)
            _fsync_path(self.dir)
            latest = os.path.join(self.dir, "LATEST")
            with open(latest + ".tmp", "w") as f:
                f.write(os.path.basename(d))
                f.flush()
                os.fsync(f.fileno())
            os.replace(latest + ".tmp", latest)
            _fsync_path(self.dir)
            if trash is not None:
                shutil.rmtree(trash, ignore_errors=True)
            self._gc()
            self._stats["saves"] += 1

        if blocking:
            try:
                _write()
            except BaseException as e:
                self._stats["save_errors"] += 1
                raise CheckpointError(
                    f"checkpoint save at step {step} failed: "
                    f"{type(e).__name__}: {e}") from e
            return

        def _guarded():
            try:
                _write()
            except BaseException as e:   # raised by wait()/save()
                self._stats["save_errors"] += 1
                self._save_error = e

        self._thread = threading.Thread(target=_guarded, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the background save; raise its failure, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._save_error is not None:
            err, self._save_error = self._save_error, None
            raise CheckpointError(f"async checkpoint save failed: "
                                  f"{type(err).__name__}: {err}") from err

    def stats(self) -> Dict[str, int]:
        return dict(self._stats)

    def _gc(self) -> None:
        removed = 0
        entries = sorted(os.listdir(self.dir))
        live = [d for d in entries if d.startswith("step_")
                and not d.endswith((".tmp", ".trash"))]
        for d in live[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)
            removed += 1
        for d in entries:
            # residue of a kill between publish and cleanup: the one write
            # in flight has renamed its own tmp away by now
            if d.startswith("step_") and d.endswith((".tmp", ".trash")):
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)
                removed += 1
        self._stats["gc_removed"] += removed

    # -- restore --------------------------------------------------------
    def steps(self) -> List[int]:
        """Complete steps on disk (manifest present), ascending."""
        out = []
        try:
            entries = os.listdir(self.dir)
        except OSError:
            return out
        for d in sorted(entries):
            if not d.startswith("step_") or d.endswith((".tmp", ".trash")):
                continue
            if os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                try:
                    out.append(int(d.split("_")[1]))
                except (IndexError, ValueError):
                    continue
        return out

    def latest_step(self) -> Optional[int]:
        latest = os.path.join(self.dir, "LATEST")
        if os.path.exists(latest):
            with open(latest) as f:
                name = f.read().strip()
            try:
                step = int(name.split("_")[1])
            except (IndexError, ValueError):
                step = None
            if step is not None and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                return step
        # LATEST missing or dangling (a kill inside the swap window): the
        # newest complete step on disk
        steps = self.steps()
        return steps[-1] if steps else None

    def manifest(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The manifest of ``step`` (default the latest), no payload read."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}", "manifest.json")
        with open(path) as f:
            return json.load(f)

    def restore(self, step: Optional[int] = None, device="cpu",
                names: Optional[List[str]] = None,
                shardings: Optional[Dict[str, Any]] = None):
        """Load ``step`` (default the latest) onto ``device``: returns
        (step, {tree name: tree}, extras), every tree rebuilt from its
        paths, ``PackedWeights`` included.  ``names`` picks trees;
        ``shardings`` (by tree name, a nested dict of ``Sharding``s)
        loads a tree's leaves as DTensors, this rank's slices alone."""
        manifest = self.manifest(step)
        step = manifest["step"]
        d = os.path.join(self.dir, f"step_{step:08d}")
        out: Dict[str, Any] = {}
        with np.load(os.path.join(d, "arrays.npz")) as data:
            for name, leaves in manifest["trees"].items():
                if names is not None and name not in names:
                    continue
                tree: Dict[str, Any] = {}
                for path, meta in leaves.items():
                    node = tree
                    keys = path.split(SEP)
                    for key in keys[:-1]:
                        node = node.setdefault(key, {})
                    sh = (shardings or {}).get(name)
                    for key in keys if sh is not None else ():
                        sh = sh[key]
                    node[keys[-1]] = _from_host(data[f"{name}::{path}"],
                                                meta, device, sh)
                for path, sizes in manifest.get("packed", {}).get(
                        name, {}).items():
                    keys = path.split(SEP)
                    node = tree
                    for key in keys[:-1]:
                        node = node[key]
                    fields = node[keys[-1]]
                    node[keys[-1]] = pack.PackedWeights(
                        **{f: fields.get(f) for f in pack.PackedWeights.LEAVES},
                        **sizes)
                out[name] = tree
        self._stats["restores"] += 1
        return step, out, manifest.get("extras", {})

