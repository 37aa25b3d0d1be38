"""The port's network planner (``repro_torch.core.network``) and layout
chain DP (``repro_torch.core.layout``) against the JAX package's, where
the costs are free of hardware.

The layer lists (ResNet-18's body, the MobileNet and ShuffleNet blocks)
and their per-group problems equal the reference's; the chain DP equals
brute force (seeded numpy costs, with and without flexible writes) and,
on the same options, the reference's DP.  A relayout's seconds take the
bandwidth as an argument (the port defaults to the H100's, the reference
to its TPU's), so the two are compared at one given rate.  The planner's
picks run on B8: each layer's spec is one ``conv2d_df.plan`` takes.
"""
import numpy as np
import pytest

from repro.core import layout as jlayout
from repro.core import network as jnetwork
from repro_torch.core import cost_model, layout, network
from repro_torch.core.dataflow import OS
from repro_torch.kernels import conv2d_df


def _fields(layer):
    return (layer.ih, layer.iw, layer.fh, layer.fw, layer.s, layer.cin,
            layer.cout, layer.groups, layer.in_dtype)


@pytest.mark.parametrize("build", [
    lambda mod: mod.resnet18_int8(),
    lambda mod: mod.mobilenet_block_int8(56, 64, 128),
    lambda mod: mod.mobilenet_block_int8(112, 32, 64, s=2),
    lambda mod: mod.shufflenet_stage_int8(28, 64),
    lambda mod: mod.shufflenet_stage_int8(20, 96, groups=3, rep=2),
], ids=["resnet18", "mobilenet", "mobilenet_s2", "shufflenet",
        "shufflenet_g3"])
def test_networks_equal_the_references(build):
    got, want = build(network), build(jnetwork)
    assert [_fields(x) for x in got] == [_fields(x) for x in want]
    for x, jx in zip(got, want):
        p, jp = x.problems(), jx.problems()
        assert (p.ih, p.iw, p.fh, p.fw, p.s, p.cin, p.cout, p.in_dtype) == (
            jp.ih, jp.iw, jp.fh, jp.fw, jp.s, jp.cin, jp.cout, jp.in_dtype)
        assert x.is_depthwise == jx.is_depthwise


def test_grouping_must_divide_the_channels():
    with pytest.raises(ValueError, match="must divide"):
        network.ConvLayerSpec(8, 8, 3, 3, 1, 6, 8, groups=4).problems()


def _options(rng, n_layers, n_opts, mod):
    layouts = ("NHWC", "NCHW", "NHWC8")
    return [[mod.LayerOption(layout=layouts[int(rng.integers(3))],
                             dataflow=f"d{j}",
                             cost=float(rng.uniform(0, 1e-4)),
                             out_bytes=int(rng.integers(1, 2 ** 24)))
             for j in range(n_opts)] for _ in range(n_layers)]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("flexible", (True, False))
def test_chain_dp_equals_brute_force(seed, flexible):
    rng = np.random.default_rng(seed)
    opts = _options(rng, int(rng.integers(1, 6)), int(rng.integers(1, 4)),
                    layout)
    total, choice = layout.optimize_chain(opts, flexible)
    bf_total, bf_choice = layout.brute_force_chain(opts, flexible)
    assert total == pytest.approx(bf_total, rel=1e-12, abs=0)
    cost = sum(opts[i][j].cost for i, j in enumerate(choice)) + sum(
        layout.transition_cost(opts[i - 1][choice[i - 1]], opts[i][choice[i]],
                               flexible) for i in range(1, len(opts)))
    assert cost == pytest.approx(bf_total, rel=1e-12, abs=0)


@pytest.mark.parametrize("seed", range(4))
def test_chain_dp_equals_the_references(seed):
    """Flexible writes (every transition free, as the paper finds): the
    same options give the reference's total and choice."""
    rng = np.random.default_rng(seed)
    opts = _options(rng, 5, 3, layout)
    jopts = [[jlayout.LayerOption(o.layout, o.dataflow, o.cost, o.out_bytes)
              for o in row] for row in opts]
    assert layout.optimize_chain(opts, True) == \
        jlayout.optimize_chain(jopts, True)
    assert layout.brute_force_chain(opts, True) == \
        jlayout.brute_force_chain(jopts, True)
    assert layout.optimize_chain([], False) == (0.0, [])


def test_transition_cost_equals_the_references_at_one_rate():
    a = layout.LayerOption("NHWC", "OS", 1e-5, out_bytes=3 << 20)
    b = layout.LayerOption("NCHW", "OS", 2e-5, out_bytes=1 << 20)
    ja = jlayout.LayerOption("NHWC", "OS", 1e-5, out_bytes=3 << 20)
    jb = jlayout.LayerOption("NCHW", "OS", 2e-5, out_bytes=1 << 20)
    for flexible in (True, False):
        for rate in (1e12, 3.35e12):
            assert layout.transition_cost(a, b, flexible, rate) == \
                jlayout.transition_cost(ja, jb, flexible, rate)
    assert layout.transition_cost(a, b, False) == \
        2.0 * a.out_bytes / cost_model.H100.hbm_bw


def test_resnet18_plan_runs_on_b8():
    net = network.resnet18_int8()
    plan = network.optimize_network(net)
    assert len(plan.layers) == len(net)
    assert plan.total_seconds == pytest.approx(
        sum(lp.est_seconds for lp in plan.layers))
    for lp in plan.layers:
        conv2d_df.plan(lp.spec, lp.layer.problems(),
                       cost_model.TORCH_DTYPES[lp.layer.in_dtype])
        assert lp.spec.anchor == OS
    assert "total:" in plan.describe()


def test_grouped_layers_cost_their_groups():
    (dw, pw) = network.mobilenet_block_int8(56, 64, 128)
    top = network.plan_layer(dw, top=1)[0]
    one = network.plan_layer(network.ConvLayerSpec(56, 56, 3, 3, 1, 1, 1),
                             top=1)[0]
    assert top[0] == one[0]
    assert top[1] == pytest.approx(64 * one[1])
    plan = network.optimize_network(
        network.mobilenet_block_int8(56, 64, 128)
        + network.shufflenet_stage_int8(28, 64), flexible_writes=False,
        layouts=("NHWC", "NCHW"))
    assert len(plan.layers) == 2 + 9
