"""The port's explorer (``repro_torch.core.explorer``) on the CPU.

* Every candidate it returns runs: its kernel's planner does not raise
  at the problem's shape, and each runs through the public op.
* Its candidate space is the reference's (``repro.core.explorer``): the
  same anchors and auxiliary variants, pruned by Observations 1, 4 and 5
  the same way, at the port's compiled blocks instead of a block sweep.
* The picks the H100 constant gives on the CPU for ``chip_smoke.py``'s
  serve hot problems are the picks the card reported
  (``SERVE_PICKS``), so a CPU engine ranks as the card does.
* The measure hooks run each spec through the public op and rank by
  time; the registry serves the four problem types.
"""
import dataclasses
import pathlib
import sys

import pytest
import torch

from repro.core import cost_model as jcm
from repro.core import explorer as jex
from repro.core.dataflow import ConvProblem as JConv
from repro.core.dataflow import GemmProblem as JGemm
from repro_torch import configs
from repro_torch.core import cost_model, explorer
from repro_torch.core.dataflow import (AttentionProblem, BinaryProblem,
                                       ConvProblem, DataflowSpec, GemmProblem,
                                       ProblemRegistration, register_problem,
                                       registered_kinds, registration_for,
                                       IS, OS, WS)
from repro_torch.kernels import binary_mm, conv2d_df, matmul_df

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

# The analytical picks of chip_smoke.py's serve hot problems on the card
# (its autotune phase, NVIDIA H100 80GB HBM3 at 700 W; PERF.md §6):
# basic OS on every MLP GEMM and B2 (OS) on every attention, except at
# bf16: B5b (the output row stripe) at the 17-token prompt's down
# projection (K = d_ff = 6144), B5a (the output column stripe) at both
# projections of the 200-token prompt.
SERVE_PICKS = {(17, 6144): "IS+o:stripe", (200, 2048): "WS+o:stripe",
               (200, 6144): "WS+o:stripe"}


@pytest.fixture(autouse=True)
def _private_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))


def _aux_set(specs):
    return {(s.anchor.value, tuple((o.value, r.value) for o, r in s.aux))
            for s in specs}


@pytest.mark.parametrize("prune", (True, False))
def test_gemm_candidate_space_is_the_references(prune):
    """A small problem under a large budget, where every reference
    candidate fits: the anchors and residencies it enumerates are the
    port's specs."""
    jp = JGemm(m=64, k=64, n=64)
    hw = jcm.HardwareSpec(vmem_bytes=2 ** 40)
    want = _aux_set(c.spec for c in jex.enumerate_candidates(
        jp, hw, prune_with_observations=prune))
    got = _aux_set(explorer.gemm_specs(prune_with_observations=prune))
    assert got == want
    assert all(s.block == matmul_df.BLOCK
               for s in explorer.gemm_specs(prune_with_observations=prune))


def test_conv_binary_and_attention_spaces_are_the_references():
    jc = JConv(ih=9, iw=9, fh=3, fw=3, s=1, cin=8, cout=8)
    hw = jcm.HardwareSpec(vmem_bytes=2 ** 40)
    assert _aux_set(explorer.conv_specs()) == _aux_set(
        c.spec for c in jex.enumerate_conv_candidates(jc, hw))
    from repro.core.dataflow import AttentionProblem as JAtt
    from repro.core.dataflow import BinaryProblem as JBin
    assert _aux_set(explorer.binary_specs()) == _aux_set(
        c.spec for c in jex.enumerate_binary_candidates(
            JBin(m=8, kp=2, n=8, n_bits=64), hw))
    p = AttentionProblem(bh=4, sq=9, skv=9, d=32, group=2, dtype="bfloat16")
    assert _aux_set(explorer.attention_specs(p)) == _aux_set(
        c.spec for c in jex.enumerate_attention_candidates(
            JAtt(bh=4, sq=9, skv=9, d=32, group=2), hw))


def _problems():
    cfg = configs.get("qwen3-1.7b")
    out = [p for _, p in chip_smoke.serve_hot_problems(cfg)]
    out += [p for _, p in chip_smoke.paper_problems()]
    out += [GemmProblem(37, 64, 48), GemmProblem(3, 96, 33, "float32"),
            GemmProblem(20, 64, 96, "int8", "float32", "int32", 5),
            BinaryProblem(20, 5, 70, 150),
            ConvProblem(9, 11, 3, 3, 2, 5, 7, in_dtype="float32",
                        out_dtype="float32")]
    return out


def test_every_candidate_is_feasible_under_its_plan():
    seen = 0
    for p in _problems():
        for c in explorer.explore(p, top=99):
            assert c.feasible and 0 < c.est_seconds < float("inf"), (p, c)
            if isinstance(p, GemmProblem):
                matmul_df.plan(c.spec, p.m, p.k, p.n,
                               cost_model.TORCH_DTYPES[p.in_dtype],
                               p.weight_bits)
            elif isinstance(p, ConvProblem):
                conv2d_df.plan(c.spec, p, cost_model.TORCH_DTYPES[p.in_dtype],
                               p.weight_bits)
            elif isinstance(p, BinaryProblem):
                binary_mm.plan(c.spec, p.m, p.kp, p.n)
            seen += 1
    assert seen > 100


def test_infeasible_specs_are_left_out():
    """At qwen3-1.7b's prefill width no weight stripe fits a block: the
    explorer drops what ``matmul_df.plan`` refuses."""
    p = GemmProblem(511, 2048, 6144)
    names = {c.name for c in explorer.explore(p, top=99)}
    assert "OS" in names
    assert not names & {"OS+w:stripe", "OS+w:whole", "WS"}


def test_cpu_picks_for_the_serve_hot_problems_are_the_cards():
    cfg = configs.get("qwen3-1.7b")
    rows = chip_smoke.serve_hot_problems(cfg)
    assert len(rows) == 38
    for label, p in rows:
        want = "OS"
        if label.startswith("bf16"):
            want = SERVE_PICKS.get((p.m, p.k), "OS")
        assert explorer.best_spec(p, cost_model.H100).name == want, \
            (label, p)


def test_measure_hooks_run_every_candidate_on_the_cpu():
    for p in (GemmProblem(20, 64, 96),
              GemmProblem(20, 64, 96, "int8", "float32", "int32", 4),
              BinaryProblem(20, 4, 96, 128),
              ConvProblem(9, 9, 3, 3, 1, 8, 16),
              AttentionProblem(8, 9, 9, 32, 2, dtype="bfloat16"),
              AttentionProblem(8, 1, 40, 32, 2, dtype="bfloat16",
                               kv_dtype="int8")):
        specs = [c.spec for c in explorer.explore(p, top=99)]
        ranked = registration_for(p).measure(p, specs, iters=1)
        assert sorted(s.name for s, _ in ranked) == sorted(
            s.name for s in specs)
        times = [t for _, t in ranked]
        assert times == sorted(times) and all(t > 0 for t in times)
        outs = [fn() for _, fn in explorer.candidate_calls(p, specs)]
        assert all(torch.equal(o, outs[0]) for o in outs), p


def test_registry_serves_the_four_problem_types():
    assert registered_kinds() == {"gemm": GemmProblem, "conv": ConvProblem,
                                  "bin": BinaryProblem,
                                  "attn": AttentionProblem}
    reg = registration_for(GemmProblem)
    with pytest.raises(ValueError, match="already registered"):
        register_problem(dataclasses.replace(reg, problem_cls=tuple))
    with pytest.raises(TypeError, match="not a registered"):
        registration_for(3.0)


def test_explore_ranks_by_estimate_then_bytes():
    p = GemmProblem(4, 2048, 6144)
    ranked = explorer.explore(p, top=99)
    keys = [(c.est_seconds, c.traffic_bytes) for c in ranked]
    assert keys == sorted(keys)
    assert explorer.explore(p, top=2) == ranked[:2]
    assert explorer.best_spec(p) == ranked[0].spec
    with pytest.raises(ValueError, match="no feasible dataflow"):
        explorer.best_spec(AttentionProblem(4, 9, 9, 48, 2))
