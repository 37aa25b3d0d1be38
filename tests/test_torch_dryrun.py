"""The port's dry-run (``repro_torch.launch.dryrun``) on a 2x4 fake mesh,
the twin of ``tests/test_perf_paths.py``'s mini dry-run.

A process group is per process, so the cells run in a subprocess (the
``"fake"`` group at world size 8, rank 0): qwen3-moe's smoke config takes
one train step (its record carries the collectives, the expert
all-to-all among them), and on a 4-layer dense smoke config
``derive_costs``' L1/L2 extrapolation equals a full-depth count: FLOPs
and collective bytes exactly, the peak live bytes within 0.1%.  The
records render (``bench/render.py``) with the roofline on the H100.
"""
import json
import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

SCRIPT = r'''
import dataclasses, json, sys
from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun

out = sys.argv[1]
moe = dryrun.lower_cell("qwen3-moe-235b-a22b", "train_4k", mesh_shape=(2, 4),
                        cfg=configs.get_smoke("qwen3-moe-235b-a22b"))
dryrun.save_record(moe, out)
cfg = dataclasses.replace(configs.get_smoke("qwen3-1.7b"), n_layers=4)
mesh = dryrun.make_mesh(mesh_shape=(2, 4))
shape = SHAPES["decode_32k"]
full = dryrun._flat_costs(dryrun.measure(cfg, shape, mesh))
derived = dryrun.derive_costs(cfg, shape, mesh)
json.dump({"moe": moe, "full": full, "derived": derived},
          open(out + "/result.json", "w"))
'''


def test_mini_dryrun_on_fake_mesh(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC)}
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    res = json.load(open(tmp_path / "result.json"))

    rec = res["moe"]
    assert rec["mesh"] == [2, 4] and rec["chips"] == 8
    assert rec["mesh_axes"] == ["data", "model"] and rec["kind"] == "train"
    kinds = rec["collectives"]["by_kind_count"]
    assert kinds.get("all-to-all", 0) > 0 and kinds.get("all-gather", 0) > 0
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["cost"]["flops"] > 0
    d = rec["derived"]
    assert d["method"] == "L1_L2_extrapolation" and d["flops"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert os.path.exists(tmp_path / "qwen3-moe-235b-a22b__train_4k__2x4.json")

    full, derived = res["full"], res["derived"]
    for key in ("flops", "collective_bytes",
                "collective_bytes_bf16_projected"):
        assert derived[key] == full[key], key
    assert abs(derived["temp_size_in_bytes"] - full["temp_size_in_bytes"]) \
        <= 1e-3 * full["temp_size_in_bytes"]


def test_render_reads_the_records(tmp_path):
    from repro_torch.bench import render, roofline
    rec = {"arch": "qwen3-1.7b", "shape": "train_4k", "mesh": [16, 16],
           "chips": 256, "kind": "train", "microbatches": 8, "seconds": 1.0,
           "memory": {"argument_size_in_bytes": 2**30,
                      "temp_size_in_bytes": 2**30},
           "collectives": {"by_kind_count": {"all-gather": 3}},
           "derived": {"flops": 1e13, "collective_bytes": 1e9,
                       "collective_bytes_bf16_projected": 5e8}}
    (tmp_path / "qwen3-1.7b__train_4k__16x16.json").write_text(
        json.dumps(rec))
    text = render.render(str(tmp_path))
    assert "| qwen3-1.7b | train_4k | train | 8 |" in text
    assert "Roofline on the H100" in text
    rows = json.load(open(tmp_path / "roofline.json"))
    assert rows[0]["fits_80g"] and rows[0]["dominant"] in (
        "compute", "memory", "collective")
    assert abs(rows[0]["t_compute"] - 1e13 / roofline.H100.peak_for(
        "bfloat16")) < 1e-12
