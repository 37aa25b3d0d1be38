"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step on fake
tensors over a fake process group, and record its costs.

The twin of ``repro/launch/dryrun.py``.  Where the reference lowers and
compiles a step against 256 or 512 forced host devices, this initializes
the ``"fake"`` process group (``FakeStore``) at world size 256 (16x16
``("data", "model")``) or 512 (2x16x16 ``("pod", "data", "model")``) as
rank 0, builds the production mesh on it, and runs the real step
function (the train step for train shapes, ``lm.prefill`` for prefill,
the decode serve step for decode) on DTensors whose local shards are
``FakeTensorMode`` tensors: shapes without storage, so no cell allocates
its parameters.  Every collective returns at once; the step runs under
``flags.exact_cost_mode()`` (every kernel wrapper takes its plain twin,
so the counter sees ATen operators and no kernel needs a fake
implementation) and under ``hlo_analysis``'s counters:

  * memory     — the argument shards' bytes and the peak live bytes,
  * cost       — FLOPs (``FlopCounterMode``; per rank: the matrix
                 products run on local shards inside ``local_map``),
  * collectives — bytes and counts by kind (``CollectiveCounter``).

A fake step's host time grows with depth, so the record is taken at one
and at two layers and extrapolated to the config's depth
(``derive_costs``: total(L) = cost(1) + (L - 1) * [cost(2) - cost(1)],
exact for a homogeneous stack; hymba's two layer classes are derived
apart), with the measured two-layer run's counters beside it.  PyTorch
runs eagerly, so nothing is counted once per loop as an XLA while-loop
body is: the extrapolation bounds the host time, and ``--full-depth``
runs the whole stack instead.  A decode cell decodes at the last
position of a full cache (``index = seq_len - 1``).

Records go to ``dryrun_results/<arch>__<shape>__<mesh>.json`` under the
current directory (``--out`` elsewhere; listed in ``.gitignore``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional, Sequence

import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES, input_specs
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import mesh_axes
from repro_torch.models import flags, lm, parallel

RESULTS_DIR = "dryrun_results"
KEYS = ("flops", "collective_bytes", "collective_bytes_bf16_projected",
        "temp_size_in_bytes")


def init_fake_group(world: int) -> None:
    """The ``"fake"`` process group at ``world`` ranks, this process rank
    0 (an existing group of that size is kept)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is up; this cell needs {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_mesh(multi_pod: bool = False,
              mesh_shape: Optional[Sequence[int]] = None):
    """The production mesh (or ``mesh_shape``, ``("data", "model")`` for
    2 dims, ``("pod", "data", "model")`` for 3) on the fake group."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(mesh_shape) if mesh_shape else (
        (2, 16, 16) if multi_pod else (16, 16))
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    world = 1
    for d in shape:
        world *= d
    init_fake_group(world)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def _dist_for(mesh) -> lm.Dist:
    dp, tp = mesh_axes(mesh)
    return lm.Dist(mesh=mesh, dp_axes=dp, tp_axis=tp)


def _fake(spec: torch.Tensor) -> torch.Tensor:
    return torch.zeros(spec.shape, dtype=spec.dtype)


def _step(cfg, shape, dist, remat: str, microbatches: int):
    """(the cell's step as a thunk, its argument trees), on fake tensors
    (call inside ``FakeTensorMode``)."""
    from repro_torch.optim import AdamW, schedules
    from repro_torch.serve.engine import make_serve_step
    from repro_torch.train.step import make_train_step

    params = parallel.shard_params(lm.init_model(cfg, seed=0, device="cpu"),
                                   dist.mesh)
    specs = {k: _fake(v) for k, v in input_specs(cfg, shape).items()}
    if shape.kind == "train":
        # >100B models: bf16 moments (halves the optimizer's bytes)
        mdt = "bfloat16" if cfg.param_count() > 100e9 else "float32"
        opt = AdamW(lr_fn=lambda s: schedules.cosine(s, 100, 10_000, 3e-4),
                    moment_dtype=mdt)
        opt_state = opt.init(params)
        step = make_train_step(cfg, opt, remat=remat,
                               microbatches=microbatches, dist=dist)
        return (lambda: step(params, opt_state, specs),
                [params, {"m": opt_state.m, "v": opt_state.v}, specs])
    if shape.kind == "prefill":
        return (lambda: lm.prefill(params, specs["tokens"], cfg,
                                   enc_frames=specs.get("enc_frames"),
                                   dist=dist), [params, specs])
    if shape.kind == "decode":
        cache = parallel.init_cache(
            dist, cfg, shape.global_batch, shape.seq_len, cfg.act_dtype,
            "cpu", enc_len=shape.seq_len if cfg.is_encoder_decoder else None)
        cache["index"] = shape.seq_len - 1
        serve_step = make_serve_step(cfg, dist=dist)
        return (lambda: serve_step(params, cache, specs["tokens"]),
                [params, cache, specs])
    raise ValueError(shape.kind)


def measure(cfg, shape, mesh, remat: str = "full",
            microbatches: int = 1) -> Dict:
    """One fake run of the cell's step under the counters."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    dist = _dist_for(mesh)
    with FakeTensorMode(), flags.exact_cost_mode():
        step, args = _step(cfg, shape, dist, remat, microbatches)
        counter = hlo_analysis.CollectiveCounter()
        with counter, FlopCounterMode(display=False) as flops:
            step()
        mem = hlo_analysis.memory_summary(args, counter)
    cost = hlo_analysis.cost_summary(flops)
    coll = counter.stats
    return {
        "memory": mem, "cost": cost,
        "collectives": {"total_bytes": coll.total_bytes,
                        "bf16_projected_bytes": coll.bf16_projected_bytes,
                        "by_kind_bytes": coll.bytes_by_kind,
                        "by_kind_count": coll.count_by_kind},
    }


def _flat_costs(rec: Dict) -> Dict[str, float]:
    return {
        "flops": rec["cost"]["flops"],
        "collective_bytes": float(rec["collectives"]["total_bytes"]),
        "collective_bytes_bf16_projected":
            float(rec["collectives"]["bf16_projected_bytes"]),
        "temp_size_in_bytes": rec["memory"]["temp_size_in_bytes"],
        "collective_by_kind": rec["collectives"]["by_kind_bytes"],
    }


def _with_layers(cfg, n: int):
    over = {"n_layers": n}
    if cfg.is_encoder_decoder:
        over["n_enc_layers"] = n
    return dataclasses.replace(cfg, **over)


def derive_costs(cfg, shape, mesh, remat: str = "full",
                 microbatches: int = 1, runs: Optional[Dict] = None) -> Dict:
    """Per-rank costs at the config's depth from runs at 1 and 2 layers:
    total(L) = cost(1) + (L - 1) * [cost(2) - cost(1)] (an
    encoder-decoder's encoder scaled with its decoder, as the
    reference's).  A stack of two layer classes (hymba: full attention on
    three layers, a window on the rest) is derived per class."""
    big_l = cfg.n_layers

    def homogeneous(cfg_h):
        return {n: _flat_costs(measure(_with_layers(cfg_h, n), shape, mesh,
                                       remat, microbatches))
                for n in (1, 2)}

    out: Dict = {}
    if cfg.attn_window is not None and cfg.full_attn_every:
        out["method"] = "two_class_L1_L2_extrapolation"
        rf = homogeneous(dataclasses.replace(cfg, attn_window=None))
        rs = homogeneous(dataclasses.replace(cfg, full_attn_every=0))
        n_full = len({0, big_l // 2, big_l - 1})
        n_swa = big_l - n_full
        for key in KEYS:
            d_full = max(rf[2][key] - rf[1][key], 0.0)
            d_swa = max(rs[2][key] - rs[1][key], 0.0)
            base = rf[1][key] - d_full
            out[key] = base + n_full * d_full + n_swa * d_swa
            out[f"{key}_per_layer"] = d_swa
        out["collective_by_kind_L2"] = rf[2]["collective_by_kind"]
        return out
    out["method"] = "L1_L2_extrapolation"
    recs = runs if runs is not None else homogeneous(cfg)
    for key in KEYS:
        delta = recs[2][key] - recs[1][key]
        if delta < 0:
            out[f"{key}_unstable"] = True
            out[key] = recs[2][key] * big_l / 2.0
            out[f"{key}_per_layer"] = recs[2][key] / 2.0
        else:
            out[key] = recs[1][key] + (big_l - 1) * delta
            out[f"{key}_per_layer"] = delta
    out["collective_by_kind_L2"] = recs[2]["collective_by_kind"]
    return out


def _argument_bytes(cfg, shape, mesh, remat: str, microbatches: int
                    ) -> float:
    """The argument shards' bytes at the config's full depth (made, not
    run: fake tensors cost nothing to build)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(), flags.exact_cost_mode():
        _, args = _step(cfg, shape, _dist_for(mesh), remat, microbatches)
        return hlo_analysis.memory_summary(
            args, hlo_analysis.CollectiveCounter())["argument_size_in_bytes"]


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               remat: str = "full", microbatches: int = 1,
               derive: bool = True, full_depth: bool = False,
               mesh_shape: Optional[Sequence[int]] = None,
               cfg=None) -> Dict:
    """Run one cell; return its record (the reference's keys)."""
    cfg = cfg or configs.get(arch)
    shape = SHAPES[shape_name]
    mesh = make_mesh(multi_pod, mesh_shape)
    t0 = time.time()
    record: Dict = {
        "arch": arch, "shape": shape_name,
        "mesh": list(mesh.shape), "mesh_axes": list(mesh.mesh_dim_names),
        "chips": mesh.size(), "kind": shape.kind,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "remat": remat, "microbatches": microbatches,
        "flops_counted": "per rank, inside local_map regions",
        "measured_layers": cfg.n_layers if full_depth else 2,
    }
    if full_depth:
        main = measure(cfg, shape, mesh, remat, microbatches)
        runs = None
    else:
        runs = {n: measure(_with_layers(cfg, n), shape, mesh, remat,
                           microbatches) for n in (1, 2)}
        main = runs[2]
        runs = {n: _flat_costs(r) for n, r in runs.items()}
    record["lower_seconds"] = round(time.time() - t0, 2)
    record.update(main)
    if derive:
        try:
            d = derive_costs(cfg, shape, mesh, remat, microbatches,
                             runs=None if full_depth else runs)
            record["derived"] = d
            record["memory"] = dict(record["memory"])
            args = _argument_bytes(cfg, shape, mesh, remat, microbatches)
            record["memory"]["argument_size_in_bytes"] = args
            record["memory"]["temp_size_in_bytes"] = d["temp_size_in_bytes"]
            record["memory"]["peak_memory_in_bytes"] = \
                args + d["temp_size_in_bytes"]
        except Exception as e:   # derivation is best-effort
            record["derived_error"] = f"{type(e).__name__}: {e}"
    record["seconds"] = round(time.time() - t0, 2)
    return record


def save_record(record: Dict, out_dir: str = RESULTS_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    mesh_tag = "x".join(str(d) for d in record["mesh"])
    fname = f"{record['arch']}__{record['shape']}__{mesh_tag}.json"
    path = os.path.abspath(os.path.join(out_dir, fname))
    with open(path, "w") as f:
        json.dump(record, f, indent=2)
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="0 = auto (8 for train shapes, 1 otherwise)")
    ap.add_argument("--full-depth", action="store_true",
                    help="run every layer instead of extrapolating")
    ap.add_argument("--no-derive", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a, s, _, _ in configs.all_cells()]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape (or --all) required")
        skipped, reason = configs.cell_skipped(args.arch, args.shape)
        if skipped:
            print(f"SKIP {args.arch} x {args.shape}: {reason}")
            return
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in cells:
        tag = f"{arch} x {shape} x {'2x16x16' if args.multi_pod else '16x16'}"
        mb = args.microbatches or (8 if SHAPES[shape].kind == "train" else 1)
        try:
            rec = lower_cell(arch, shape, multi_pod=args.multi_pod,
                             remat=args.remat, microbatches=mb,
                             derive=not args.no_derive,
                             full_depth=args.full_depth)
            path = save_record(rec, args.out)
            mem = rec.get("memory", {})
            per_dev = (mem.get("argument_size_in_bytes", 0)
                       + mem.get("temp_size_in_bytes", 0)) / 2**30
            d = rec.get("derived", {})
            flops = d.get("flops", rec["cost"]["flops"])
            coll = d.get("collective_bytes",
                         rec["collectives"]["total_bytes"])
            print(f"OK   {tag}: {rec['seconds']}s mem/dev={per_dev:.2f}GiB "
                  f"flops={flops:.3e} coll={coll:.3e}B -> "
                  f"{os.path.basename(path)}")
        except Exception as e:
            failures += 1
            print(f"FAIL {tag}: {type(e).__name__}: {e}")
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
