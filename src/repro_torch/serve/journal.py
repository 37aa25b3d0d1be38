"""Durable request journal: append-only JSONL write-ahead log.

The port's copy of ``repro/serve/journal.py`` (the same records in the
same CRC-32 envelope, so either package reads the other's journal).
Every state transition the serving engine makes is journaled *before*
it is acted on, so a process kill can never lose a request — the
restarted engine rebuilds the request table from the journal and
replays in-flight requests to their exact decode position
(serve/engine.py ``Engine.restore``).  Record kinds:

    submit    rid, prompt (token list), max_new_tokens, deadline_s —
              written at admission, fsync'd (a request the caller was
              told is admitted must survive a crash)
    serve     rids (batch order), seed, greedy, prompt_len — the batch
              composition a recovery must reproduce
    token     rid, step, token — one per emitted token (flushed, not
              fsync'd: greedy decode is deterministic, so a lost tail
              of token records is recomputed bit-exactly from params +
              prompt; the fsync is saved for the transitions that are
              *not* recomputable)
    snapshot  step — marks that ``Engine.snapshot`` committed a
              checkpoint covering everything before it
    preempt   rid, step, tokens_done — memory-pressure preemption
              (fsync'd): the request's pages were released and it was
              re-queued; its journaled tokens stay as replay
              expectations for the deterministic recompute
    done / failed / evicted
              rid, step, error — terminal transitions, fsync'd

Corruption contract: each line is a
``{"rec": ..., "sum": <crc32>}`` envelope over the canonical JSON of
the record.  ``scan`` validates per record — a bit-flipped or
truncated line (e.g. the torn tail a mid-append kill leaves) is
skipped and counted, never fatal, and never poisons its neighbors.

The ``journal.append`` fault-injection site fires before any bytes are
written, so an armed ``kill`` drills the crash-before-durable window
and an armed ``raise`` drills the degraded-durability path: append
failures are counted (``stats()['append_errors']``), not raised —
losing the journal degrades crash *recovery*, it must not take down
crash-free *serving*.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, List, Optional

from repro_torch.runtime import health

health.register_site("journal.append")


def journal_dir() -> Optional[str]:
    """The ``REPRO_JOURNAL_DIR`` env flag: default location engines
    journal to when not given an explicit directory."""
    return os.environ.get("REPRO_JOURNAL_DIR") or None


def _checksum(rec: dict) -> int:
    blob = json.dumps(rec, sort_keys=True, separators=(",", ":")).encode()
    return zlib.crc32(blob) & 0xFFFFFFFF


class RequestJournal:
    """Append-only JSONL journal with per-record CRC-32 envelopes."""

    def __init__(self, directory: str, name: str = "journal.jsonl"):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, name)
        self._f = None
        self._stats: Dict[str, int] = {
            "appends": 0,         # records durably handed to the OS
            "fsyncs": 0,          # appends that also forced the platters
            "append_errors": 0,   # I/O or injected faults (degraded)
            "records_loaded": 0,  # scan: envelope + CRC accepted
            "records_skipped": 0,  # scan: malformed / checksum-failed
            "torn_tail": 0,       # scan: unterminated final line dropped
        }

    # -- write --------------------------------------------------------------
    def _file(self):
        if self._f is None or self._f.closed:
            self._f = open(self.path, "a")
        return self._f

    def append(self, kind: str, fsync: bool = False, **fields) -> dict:
        """Journal one record; returns it.  Never raises: a failed
        append (disk full, injected fault) is counted in
        ``stats()['append_errors']`` and serving continues with
        degraded durability."""
        rec = {"kind": kind, **fields}
        line = json.dumps({"rec": rec, "sum": _checksum(rec)},
                          sort_keys=True, separators=(",", ":"))
        try:
            health.maybe_inject("journal.append")
            f = self._file()
            f.write(line + "\n")
            f.flush()
            if fsync:
                os.fsync(f.fileno())
                self._stats["fsyncs"] += 1
            self._stats["appends"] += 1
        except (OSError, ValueError, health.SimulatedFailure):
            self._stats["append_errors"] += 1
        return rec

    def close(self) -> None:
        if self._f is not None and not self._f.closed:
            self._f.close()
        self._f = None

    # -- read ---------------------------------------------------------------
    def scan(self) -> List[dict]:
        """Validated records, in append order.

        A missing file is an empty journal; an unterminated final line
        (mid-append kill) is a torn tail, dropped and counted; any other
        malformed or CRC-mismatched line is skipped and counted.  Never
        raises past here for corruption.
        """
        try:
            with open(self.path) as f:
                raw = f.read()
        except FileNotFoundError:
            return []
        records: List[dict] = []
        lines = raw.split("\n")
        if lines and lines[-1] == "":
            lines.pop()                      # clean terminator
        elif lines and lines[-1] != "":
            self._stats["torn_tail"] += 1    # kill mid-append
            lines.pop()
        for line in lines:
            rec = self._validate(line)
            if rec is None:
                self._stats["records_skipped"] += 1
            else:
                self._stats["records_loaded"] += 1
                records.append(rec)
        return records

    @staticmethod
    def _validate(line: str) -> Optional[dict]:
        try:
            env = json.loads(line)
        except ValueError:
            return None
        if not isinstance(env, dict):
            return None
        rec = env.get("rec")
        if not isinstance(rec, dict) or "sum" not in env:
            return None
        try:
            if int(env["sum"]) != _checksum(rec):
                return None
        except (TypeError, ValueError):
            return None
        if not isinstance(rec.get("kind"), str):
            return None
        return rec

    def stats(self) -> Dict[str, int]:
        return dict(self._stats)


def replay_table(records: List[dict]) -> Dict[int, Dict[str, Any]]:
    """Fold a record stream into the per-request table it encodes.

    Returns ``{rid: {"prompt": [...], "max_new_tokens": n,
    "deadline_s": ..., "tokens": [...], "state": "queued" | "decoding"
    | "done" | "failed" | "evicted", "error": ...}}``.  Token records
    for an unknown rid (their ``submit`` line was corrupted away) are
    dropped — a request the journal cannot prove was admitted is not
    resurrected from its decode trail alone.
    """
    table: Dict[int, Dict[str, Any]] = {}
    for rec in records:
        kind = rec.get("kind")
        rid = rec.get("rid")
        if kind == "submit" and isinstance(rid, int):
            table[rid] = {
                "prompt": list(rec.get("prompt", [])),
                "max_new_tokens": int(rec.get("max_new_tokens", 0)),
                "deadline_s": rec.get("deadline_s"),
                "tokens": [],
                "state": "queued",
                "error": None,
            }
        elif kind == "token" and rid in table:
            # position-addressed: ``step`` is the 1-based token index, so
            # a replayed run re-journaling steps it already wrote
            # overwrites in place instead of duplicating, and a token
            # whose predecessors were corrupted away (a hole in the
            # prefix) is dropped rather than stitched out of order.
            row = table[rid]
            pos = rec.get("step")
            if row["state"] in ("queued", "decoding") and isinstance(
                    pos, int) and pos >= 1:
                toks = row["tokens"]
                if pos <= len(toks):
                    toks[pos - 1] = int(rec["token"])
                elif pos == len(toks) + 1:
                    toks.append(int(rec["token"]))
                row["state"] = "decoding"
        elif kind == "preempt" and rid in table:
            # memory-pressure preemption: the request went back
            # to the queue with its pages released.  Journaled tokens
            # are kept — recompute-on-resume is deterministic, so they
            # become position-addressed replay expectations that the
            # regenerated run must reproduce bit-exactly.
            if table[rid]["state"] in ("queued", "decoding"):
                table[rid]["state"] = "queued"
        elif kind in ("done", "failed", "evicted") and rid in table:
            table[rid]["state"] = kind
            table[rid]["error"] = rec.get("error")
    return table
