"""Render the dry-run and roofline tables from the port's records.

The twin of ``benchmarks/render_experiments.py``:

    PYTHONPATH=src python -m repro_torch.bench.render [--dir dryrun_results]

prints markdown: one dry-run table per mesh (16x16, 2x16x16), the
skipped cells, and the single-pod roofline (``bench/roofline.py``, run
here over the same records).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch import configs
from repro_torch.bench import roofline
from repro_torch.launch.dryrun import RESULTS_DIR


def dryrun_table(directory: str, mesh_tag: str) -> str:
    rows = [
        "| arch | shape | kind | mb | host s | args+temp GiB/dev | "
        "flops/dev | collective B/dev | a2a | ag | ar | rs |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for path in sorted(glob.glob(os.path.join(directory,
                                              f"*__{mesh_tag}.json"))):
        r = json.load(open(path))
        mem = r.get("memory", {})
        gib = (mem.get("argument_size_in_bytes", 0)
               + mem.get("temp_size_in_bytes", 0)) / 2**30
        d = r.get("derived", {})
        kinds = r.get("collectives", {}).get("by_kind_count", {})
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} | "
            f"{r.get('microbatches', 1)} | {r.get('seconds', '-')} | "
            f"{gib:.2f} | {d.get('flops', 0):.3e} | "
            f"{d.get('collective_bytes', 0):.3e} | "
            f"{kinds.get('all-to-all', 0)} | {kinds.get('all-gather', 0)} | "
            f"{kinds.get('all-reduce', 0)} | "
            f"{kinds.get('reduce-scatter', 0)} |")
    return "\n".join(rows)


def skip_table() -> str:
    rows = ["| arch | shape | reason |", "|---|---|---|"]
    for a, s, sk, reason in configs.all_cells(include_skipped=True):
        if sk:
            rows.append(f"| {a} | {s} | {reason} |")
    return "\n".join(rows)


def render(directory: str = RESULTS_DIR) -> str:
    out = ["## Dry-run — single-pod mesh 16x16 (256 ranks)\n",
           dryrun_table(directory, "16x16"),
           "\n## Dry-run — multi-pod mesh 2x16x16 (512 ranks)\n",
           dryrun_table(directory, "2x16x16"),
           "\n## Skipped cells (per assignment rules)\n", skip_table()]
    rows = roofline.run(directory, "16x16")
    if rows:
        out += ["\n## Roofline on the H100 (single-pod)\n",
                roofline.table(rows)]
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=RESULTS_DIR)
    print(render(ap.parse_args(argv).dir))


if __name__ == "__main__":
    main()
