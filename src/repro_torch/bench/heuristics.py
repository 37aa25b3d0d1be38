"""Paper Table I: the memory-instruction reductions per auxiliary vector
variable, and Observations 1-5 derived from them over the layer grid.

The twin of ``benchmarks/bench_heuristics.py``; free of any hardware, so
nothing is timed.  Rows: each Table I entry (reads and writes saved) for
the canonical 56x56 f3 s1 layer (cin 128, 128 filters), the stride-2 IS
rows with 1, 2 and 4 auxiliary variables, and a 0/1 flag for each
observation holding on every layer of the paper's grid.

    PYTHONPATH=src python -m repro_torch.bench.heuristics
"""
from __future__ import annotations

import json
from typing import List

from repro_torch.bench.common import PAPER_CIN, PAPER_LAYERS
from repro_torch.core import cost_model
from repro_torch.core.dataflow import ConvProblem, IS, OS, WS

TABLE1_ROWS = (("os_aux_input", OS, IS), ("os_aux_weight", OS, WS),
               ("ws_aux_input", WS, IS), ("ws_aux_output", WS, OS),
               ("is_aux_weight", IS, WS), ("is_aux_output", IS, OS))
OBSERVATIONS = ("obs1_ws_gains_least", "obs3_os_aux_symmetric",
                "obs4_is_output_first", "obs5_ws_output_first")


def run() -> List[dict]:
    rows = []
    conv = ConvProblem(ih=56, iw=56, fh=3, fw=3, s=1, cin=128, cout=128)
    for name, anchor, aux in TABLE1_ROWS:
        r, w = cost_model.table1_reduction(anchor, aux, conv)
        rows.append({"bench": "table1", "name": f"{name}_reads",
                     "derived": int(r)})
        rows.append({"bench": "table1", "name": f"{name}_writes",
                     "derived": int(w)})
    conv2 = ConvProblem(ih=56, iw=56, fh=3, fw=3, s=2, cin=128, cout=128)
    for nv in (1, 2, 4):
        r, _ = cost_model.table1_reduction(IS, OS, conv2, n_aux_vars=nv)
        rows.append({"bench": "table1", "name": f"is_aux_output_s2_var{nv}",
                     "derived": int(r)})
    hold = dict.fromkeys(OBSERVATIONS, True)
    for hw, f, s, nf in PAPER_LAYERS:
        c = ConvProblem(ih=hw, iw=hw, fh=f, fw=f, s=s, cin=PAPER_CIN,
                        cout=nf)
        for k, v in cost_model.paper_observations_hold(c).items():
            hold[k] &= v
    rows += [{"bench": "table1", "name": k, "derived": int(v)}
             for k, v in hold.items()]
    return rows


if __name__ == "__main__":
    for row in run():
        print(json.dumps(row))
