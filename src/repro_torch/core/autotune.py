"""Persistent autotuned dataflow-spec cache, for the port's kernels.

The twin of ``repro/core/autotune.py``: ``best_spec`` memoizes
``explorer.explore``'s pick so a workload's candidates are enumerated and
ranked at most once a process and, through a JSON store, once a machine.

Key schema (``_key``), built from the problem registry::

    v<CACHE_VERSION>|<kind>|<key_fields...>|hw=<card>|smem=<bytes>|backend=<cuda|torch>|model=<digest>

``hw`` is the card's name (``cost_model.HardwareSpec.name``; a CPU engine
and the tests rank as ``cost_model.H100``), ``smem`` the shared memory a
block may take, ``backend`` the ops' backend, ``model`` the digest of the
cost model's fitted constants (``cost_model.model_digest``), so a refit
never serves the picks stored under the constants before it.
``CACHE_VERSION`` is the port's own: 1 = the Hopper cost model over the
compiled blocks; 2 = keys carry the model's digest.

The store: ``$REPRO_AUTOTUNE_CACHE`` names the JAX package's file; the
port's is its sibling ``<stem>.torch.json`` (so a test run's temporary
path covers both, and neither package ever reads the other's entries),
else ``~/.cache/repro_torch/autotune.json``.  Each entry carries a CRC32
of its spec; a malformed or mismatched entry is skipped and counted
(``stats()['entries_skipped']``), an unparseable file is quarantined to
``<path>.corrupt-<n>``, and saves are atomic (a temporary file and
``os.replace``), so a kill mid-write (the ``autotune.save`` fault site)
leaves the previous store whole.  The ``autotune.load`` site drills a
failed read: the process keeps its in-memory cache.

``refine`` (``REPRO_AUTOTUNE_REFINE=1``; off by default, as in the
reference) re-ranks the analytical top candidates by measurement through
the registration's ``measure`` hook before caching: on the card the
public ops timed by CUDA events, on the CPU their plain path.  It changes
which feasible spec is picked, never the result of the op that uses it.

A lookup on the serving path costs a dictionary probe: ``_fast`` is keyed
by the (frozen, hashable) problem, card and backend in front of the
string key (``clear()`` it after changing the cost model's constants in
a process).
"""
from __future__ import annotations

import json
import os
import tempfile
import zlib
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.core import cost_model, explorer
from repro_torch.core.dataflow import (DataflowSpec, Residency, Stationarity,
                                       registration_for)
from repro_torch.runtime import health

CACHE_VERSION = 2

Problem = Any

_memory: Dict[str, DataflowSpec] = {}
_fast: Dict[Tuple[Any, str, int, str], DataflowSpec] = {}
_disk_loaded = False
_defer_save = False   # warm() batches its misses into one write
_stats = {
    "lookups": 0,            # best_spec calls
    "hits": 0,               # served from memory or disk
    "misses": 0,             # needed an enumeration
    "enumerations": 0,       # explorer.explore calls
    "entries_loaded": 0,     # disk entries accepted
    "entries_skipped": 0,    # malformed or checksum-failed entries
    "files_quarantined": 0,  # unparseable stores moved aside
    "load_errors": 0,        # I/O or injected faults while loading
    "save_errors": 0,        # I/O or injected faults while saving
}


def _key(problem: Problem, hw: cost_model.HardwareSpec, backend: str) -> str:
    reg = registration_for(problem)
    return "|".join([f"v{CACHE_VERSION}", reg.kind, *reg.key_fields(problem),
                     f"hw={hw.name}", f"smem={hw.smem_block}",
                     f"backend={backend}",
                     f"model={cost_model.model_digest()}"])


def cache_path() -> str:
    """The port's store: beside the JAX package's ``$REPRO_AUTOTUNE_CACHE``
    file, never that file itself."""
    env = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if env:
        stem, _ = os.path.splitext(env)
        return stem + ".torch.json"
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "autotune.json")


def _spec_to_json(spec: DataflowSpec) -> dict:
    return {"anchor": spec.anchor.value,
            "aux": [[st.value, res.value] for st, res in spec.aux],
            "aux_priority": [st.value for st in spec.aux_priority],
            "block": list(spec.block)}


def _spec_from_json(d: dict) -> DataflowSpec:
    return DataflowSpec(
        anchor=Stationarity(d["anchor"]),
        aux={Stationarity(s): Residency(r) for s, r in d["aux"]},
        aux_priority=tuple(Stationarity(s) for s in d["aux_priority"]),
        block=tuple(d["block"]))


def _checksum(spec_json: dict) -> int:
    """CRC32 of a spec payload's canonical JSON."""
    blob = json.dumps(spec_json, sort_keys=True,
                      separators=(",", ":")).encode()
    return zlib.crc32(blob) & 0xFFFFFFFF


def _entry_to_json(spec: DataflowSpec) -> dict:
    payload = _spec_to_json(spec)
    return {"spec": payload, "sum": _checksum(payload)}


def _entry_from_json(entry) -> Optional[DataflowSpec]:
    """One disk entry, validated on its own; None means skip it."""
    if not isinstance(entry, dict):
        return None
    payload = entry.get("spec")
    if not isinstance(payload, dict) or "sum" not in entry:
        return None
    try:
        if int(entry["sum"]) != _checksum(payload):
            return None
        return _spec_from_json(payload)
    except (KeyError, ValueError, TypeError):
        return None


def _quarantine(path: str) -> Optional[str]:
    """Move an unreadable store to ``<path>.corrupt-<n>`` (kept for a
    post-mortem); the target, or None if the rename failed."""
    for n in range(100):
        target = f"{path}.corrupt-{n}"
        if not os.path.exists(target):
            break
    else:
        target = f"{path}.corrupt-overflow"
    try:
        os.replace(path, target)
    except OSError:
        return None
    _stats["files_quarantined"] += 1
    return target


def _load_disk() -> None:
    """Best-effort load, each entry validated: an I/O error or the
    injected ``autotune.load`` fault leaves the in-memory cache (counted);
    an unparseable file is quarantined; bad entries are skipped.  A store
    of another version is left in place and ignored."""
    global _disk_loaded
    if _disk_loaded:
        return
    _disk_loaded = True
    path = cache_path()
    try:
        health.maybe_inject("autotune.load")
        with open(path) as f:
            raw = f.read()
    except FileNotFoundError:
        return
    except (OSError, health.SimulatedFailure):
        _stats["load_errors"] += 1
        return
    try:
        data = json.loads(raw)
        if not isinstance(data, dict):
            raise ValueError("cache root is not an object")
    except ValueError:
        _quarantine(path)
        return
    if data.get("version") != CACHE_VERSION:
        return
    entries = data.get("entries")
    if not isinstance(entries, dict):
        _quarantine(path)
        return
    for key, entry in entries.items():
        if key in _memory:
            continue
        spec = _entry_from_json(entry)
        if spec is None:
            _stats["entries_skipped"] += 1
            continue
        _memory[key] = spec
        _stats["entries_loaded"] += 1


def _save_disk() -> None:
    """Atomic, best-effort rewrite of the whole store: written to a
    temporary file beside it and moved into place, so a kill mid-write
    (the ``autotune.save`` site) leaves the previous file whole."""
    path = cache_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {"version": CACHE_VERSION,
                   "entries": {k: _entry_to_json(s)
                               for k, s in _memory.items()}}
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
                # an injected kill lands here: bytes in the temporary
                # file, the rename not done
                health.maybe_inject("autotune.save")
            os.replace(tmp, path)
        except BaseException:
            os.unlink(tmp)
            raise
    except (OSError, health.SimulatedFailure):
        _stats["save_errors"] += 1


def refine_enabled() -> bool:
    """``REPRO_AUTOTUNE_REFINE=1``: re-rank the analytical top candidates
    by measurement on a miss."""
    return os.environ.get("REPRO_AUTOTUNE_REFINE", "") == "1"


def best_spec(problem: Problem,
              hw: cost_model.HardwareSpec = cost_model.H100,
              backend: str = "cuda", refine: Optional[bool] = None,
              refine_top: int = 3, device=None) -> DataflowSpec:
    """The cached explorer pick for ``problem`` on ``hw``/``backend``;
    ``ValueError`` where no candidate is feasible.  ``refine`` (default:
    ``refine_enabled()``) measures the top ``refine_top`` on ``device``
    (the card ``hw`` names when None and one is visible, else the CPU)."""
    fast_key = (problem, hw.name, hw.smem_block, backend)
    spec = _fast.get(fast_key)
    _stats["lookups"] += 1
    if spec is not None:
        _stats["hits"] += 1
        return spec
    if refine is None:
        refine = refine_enabled()
    _load_disk()
    reg = registration_for(problem)
    key = _key(problem, hw, backend)
    spec = _memory.get(key)
    if spec is not None:
        _stats["hits"] += 1
        _fast[fast_key] = spec
        return spec
    _stats["misses"] += 1
    _stats["enumerations"] += 1
    ranked = explorer.explore(problem, hw, top=max(1, refine_top))
    if not ranked:
        raise ValueError(f"no feasible dataflow for {problem}")
    spec = ranked[0].spec
    if refine and reg.measure is not None and len(ranked) > 1:
        if device is None:
            import torch

            device = "cuda" if torch.cuda.is_available() else "cpu"
        spec = reg.measure(problem, [c.spec for c in ranked],
                           device=device)[0][0]
    _memory[key] = spec
    _fast[fast_key] = spec
    if not _defer_save:
        _save_disk()
    return spec


def warm(problems: Iterable[Problem],
         hw: cost_model.HardwareSpec = cost_model.H100,
         backend: str = "cuda") -> List[DataflowSpec]:
    """Fill the cache for a set of hot workloads (any registered types,
    mixed), with one disk write for all the misses.  A problem with no
    feasible dataflow is skipped: its op raises when it is called."""
    global _defer_save
    before = _stats["misses"]
    _defer_save = True
    specs = []
    try:
        for p in problems:
            try:
                specs.append(best_spec(p, hw, backend))
            except ValueError:
                continue
    finally:
        _defer_save = False
    if _stats["misses"] > before:
        _save_disk()
    return specs


def stats() -> Dict[str, int]:
    return dict(_stats)


def reset_stats() -> None:
    for k in _stats:
        _stats[k] = 0


def clear(disk: bool = False) -> None:
    """Drop the in-process cache; with ``disk=True`` the store too."""
    global _disk_loaded
    _memory.clear()
    _fast.clear()
    _disk_loaded = False
    if disk:
        try:
            os.unlink(cache_path())
        except OSError:
            pass
