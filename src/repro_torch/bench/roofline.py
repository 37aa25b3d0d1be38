"""Roofline per (arch x shape x mesh) from the port's dry-run records.

The twin of ``benchmarks/bench_roofline.py``, on the card the port runs
on (``cost_model.H100`` and ``cost_model.roofline``):

  compute    = FLOPs / (chips * H100 bf16 tensor-core peak)
  memory     = HBM bytes / (chips * H100 HBM rate)
  collective = collective bytes / (chips * NVLink rate)

Sources: FLOPs and collective bytes from a record's ``derived`` costs
(``launch/dryrun.py``: per rank, extrapolated to the config's depth);
HBM bytes from ``estimate_hbm_bytes``, the reference's analytic
per-device model (parameter and optimizer streams, activation carry, KV
reads, CE logit chunks).  "Fits" compares a rank's argument and peak
bytes with the card's 80 GB.

    PYTHONPATH=src python -m repro_torch.bench.roofline [--dir dryrun_results]

writes ``roofline.md`` and ``roofline.json`` beside the records.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.core.cost_model import H100, model_flops, roofline
from repro_torch.launch.dryrun import RESULTS_DIR

CARD_BYTES = 80e9          # H100 SXM device memory


def estimate_hbm_bytes(rec: Dict, cfg, shape) -> float:
    """Per-device HBM bytes per step (the reference's approximation).

    train:  3 param reads per microbatch (fwd + remat recompute + bwd)
            + optimizer stream (grads f32 r+w, moments r+w, param write)
            + activation carry (save + 2 reads) + CE logit chunks (f32 r+w)
    prefill: 1 param read + activations + KV-cache write
    decode:  1 param read (active params for MoE) + full KV-cache read
             + SSM state r+w
    """
    chips = rec["chips"]
    mb = rec.get("microbatches", 1) or 1
    p_loc = cfg.param_count() * 2 / chips                     # bf16
    p_active_loc = cfg.active_param_count() * 2 / chips
    tokens_loc = shape.global_batch * shape.seq_len / chips * \
        (1 if shape.kind != "decode" else 0)
    d = cfg.d_model
    n_layers = cfg.n_layers
    if shape.kind == "train":
        mdt = 2 if cfg.param_count() > 100e9 else 4
        opt_stream = p_loc / 2 * (4 + 4 + 2 * mdt + 2 * mdt) + p_loc
        param_stream = 3 * mb * p_active_loc
        act_carry = 3 * n_layers * tokens_loc * d * 2
        ce = 4 * tokens_loc * cfg.padded_vocab * 4
        return param_stream + opt_stream + act_carry + ce
    if shape.kind == "prefill":
        kv_write = (2 * cfg.kv_dim * tokens_loc * 2) * n_layers \
            if cfg.has_attention else 0
        act = 2 * n_layers * tokens_loc * d * 2
        return p_active_loc + act + kv_write
    kv_read = 0.0
    if cfg.has_attention:
        win_layers, full_layers = 0, n_layers
        if cfg.attn_window is not None:
            full = {0, n_layers // 2, n_layers - 1}
            win_layers = n_layers - len(full)
            full_layers = len(full)
        skv_win = min(cfg.attn_window or 0, shape.seq_len)
        kv_read = (full_layers * shape.seq_len + win_layers * skv_win) \
            * shape.global_batch * 2 * cfg.kv_dim * 2 / chips
    ssm = 0.0
    if cfg.has_ssm:
        ssm = 2 * n_layers * shape.global_batch * cfg.ssm_heads \
            * cfg.ssm_state * cfg.ssm_headdim * 4 / chips
    return p_active_loc + kv_read + ssm


def load_records(directory: str, mesh_tag: str = "16x16") -> List[Dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(directory,
                                              f"*__{mesh_tag}.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def analyse(rec: Dict) -> Optional[Dict]:
    cfg = configs.get(rec["arch"])
    shape = SHAPES[rec["shape"]]
    chips = rec["chips"]
    derived = rec.get("derived")
    if not derived or "flops" not in derived:
        return None
    flops_dev = derived["flops"]
    coll_dev = derived.get("collective_bytes_bf16_projected",
                           derived["collective_bytes"])
    hbm_dev = estimate_hbm_bytes(rec, cfg, shape)
    r = roofline(flops_dev * chips, hbm_dev * chips, coll_dev * chips,
                 chips=chips, hw=H100)
    tokens = shape.global_batch * shape.seq_len if shape.kind != "decode" \
        else shape.global_batch
    mf = model_flops(cfg.active_param_count(), tokens,
                     training=shape.kind == "train")
    mem = rec.get("memory", {})
    used = mem.get("argument_size_in_bytes", 0) + mem.get(
        "temp_size_in_bytes", 0)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "chips": chips,
        "t_compute": r.t_compute, "t_memory": r.t_memory,
        "t_collective": r.t_collective, "dominant": r.dominant,
        "bound_time": r.bound_time,
        "compute_fraction": r.compute_fraction,
        "model_flops": mf, "counted_flops": flops_dev * chips,
        "useful_ratio": mf / (flops_dev * chips) if flops_dev else 0.0,
        "fits_80g": used <= CARD_BYTES, "mem_gib": used / 2**30,
    }


def table(rows: List[Dict]) -> str:
    md = ["| arch | shape | compute s | memory s | collective s | dominant "
          "| peak-frac | 6ND/counted | mem GiB (fits 80G) |",
          "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        md.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute']:.3e} | "
            f"{r['t_memory']:.3e} | {r['t_collective']:.3e} | "
            f"{r['dominant']} | {r['compute_fraction']:.2f} | "
            f"{r['useful_ratio']:.2f} | {r['mem_gib']:.1f} "
            f"({'y' if r['fits_80g'] else 'N'}) |")
    return "\n".join(md)


def run(directory: str = RESULTS_DIR, mesh_tag: str = "16x16") -> List[Dict]:
    rows = [a for a in map(analyse, load_records(directory, mesh_tag)) if a]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "roofline.md"), "w") as f:
        f.write(table(rows) + "\n")
    with open(os.path.join(directory, "roofline.json"), "w") as f:
        json.dump(rows, f, indent=2)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=RESULTS_DIR)
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    rows = run(args.dir, args.mesh)
    print(f"# wrote {os.path.join(args.dir, 'roofline.md')} "
          f"({len(rows)} cells)")


if __name__ == "__main__":
    main()
