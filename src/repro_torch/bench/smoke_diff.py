"""Compare two ``chip_smoke.py`` logs: what each phase served and launched.

    python3 src/repro_torch/bench/smoke_diff.py <old log> <new log>

For every JSON event of the old log that carries ``tokens`` (a serve
phase's drain, main path or router check) or ``launches`` /
``launches_by_path``, the first event of the same (phase, event, config)
in the new log is found and the two compared: the tokens equal or not
(the output bits of a greedy serve), the launch counts equal or the
kernels whose counts differ.  Prints one JSON line per compared event and
a summary; exits 1 when a compared event differs or is missing.  Runs on
any machine (it reads text only).
"""
from __future__ import annotations

import json
import sys
from typing import Dict, Iterator, Tuple

Key = Tuple[str, str, str, int]


def events(path: str) -> Iterator[dict]:
    with open(path) as f:
        for line in f:
            if line.startswith("{"):
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    continue


def keyed(path: str) -> Dict[Key, dict]:
    """Each phase event with tokens or launches, by (phase, event, config,
    its index among events of that key)."""
    seen: Dict[Tuple[str, str, str], int] = {}
    out: Dict[Key, dict] = {}
    for ev in events(path):
        if "phase" not in ev or not any(
                k in ev for k in ("tokens", "launches", "launches_by_path")):
            continue
        base = (str(ev["phase"]), str(ev.get("event")),
                str(ev.get("config", ev.get("name", ""))))
        n = seen.get(base, 0)
        seen[base] = n + 1
        out[base + (n,)] = ev
    return out


def compare(old: dict, new: dict) -> dict:
    rec = {}
    if "tokens" in old:
        rec["tokens_equal"] = old["tokens"] == new.get("tokens")
    for field in ("launches", "launches_by_path"):
        if isinstance(old.get(field), dict):
            a, b = old[field], new.get(field) or {}
            differ = {k: [a.get(k), b.get(k)] for k in sorted(set(a) | set(b))
                      if a.get(k, 0) != b.get(k, 0)}
            rec[f"{field}_differ"] = differ
    return rec


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__.strip().splitlines()[2], file=sys.stderr)
        return 2
    old, new = keyed(argv[0]), keyed(argv[1])
    bad = 0
    for key, ev in old.items():
        if key not in new:
            print(json.dumps({"event": list(key), "missing": True}))
            bad += 1
            continue
        rec = compare(ev, new[key])
        same = rec.get("tokens_equal", True) and not any(
            v for k, v in rec.items() if k.endswith("_differ"))
        bad += not same
        print(json.dumps({"event": list(key), "same": same, **rec}))
    print(json.dumps({"compared": len(old), "differ_or_missing": bad,
                      "new_only": len(set(new) - set(old))}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
