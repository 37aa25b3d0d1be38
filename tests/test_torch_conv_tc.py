"""B8 on the tensor cores (``csrc/conv_tc.cuh``): what the CPU can hold,
and the card-only checks.

On the CPU: ``conv2d_df.plan`` names the tensor-core tile of every int8,
packed and bf16 conv (the OS tile the rule picks, with its CTAs, ring
bytes and split of k; the WS and IS walks with their grids and the bytes
they held before), feasibility is the planner's before the redesign (the
bits and a sha256 of its refusal messages), a launch whose report differs
from its plan raises, and two pieces of the kernels' arithmetic as design
notes in numpy: the A gather (each pixel's window origin and each
reduction index's offset, 16-byte units where Cin allows, single elements
otherwise, zeros past the image, K and a packed filter's pad channels)
against an im2col of the image, and the integer split of k merged by the
tile's last CTA.

On the card (marker ``card``, skipped here): int8, packed 4/5-bit (with
outlier rows the image hits) and bf16 convs at every anchor and epilogue
stage, ragged shapes and a layer per tile: integers equal their plain
version bit for bit, bf16 within B1's tolerance, and every anchor equals
OS bit for bit.  This module imports no JAX, so on the card:

    PYTHONPATH=src python -m pytest --noconftest -q -m card \\
        tests/test_torch_conv_tc.py
"""
import hashlib
import itertools

import numpy as np
import pytest
import torch

from repro_torch.bench.binary import VGG_LAYERS
from repro_torch.bench.conv import RESNET18
from repro_torch.core.dataflow import (ConvProblem, DataflowSpec, IS, OS, WS,
                                       registered_kernels)
from repro_torch.kernels import _build, conv2d_df, matmul_df, ops, pack, ref

SPECS = {name: DataflowSpec.basic(a, block=conv2d_df.BLOCK)
         for name, a in (("os", OS), ("ws", WS), ("is", IS))}
KINDS = {"int8": (torch.int8, None), "packed4": (torch.int8, 4),
         "packed5": (torch.int8, 5), "bf16": (torch.bfloat16, None)}
# (n, ih, iw, f, s, cin, cout): every ResNet-18 and VGG layer, then the
# ragged cases of tests/test_torch_conv.py and chip_smoke.py.
SHAPES = ([(1, ih, iw, f, s, cin, cout)
           for ih, iw, f, s, cin, cout, _ in RESNET18]
          + [(1, ih, iw, f, s, cin, cout)
             for ih, iw, f, s, cin, cout in VGG_LAYERS]
          + [(1, 9, 8, 3, 1, 5, 6), (2, 11, 10, 3, 2, 7, 10),
             (1, 14, 13, 3, 1, 20, 70), (2, 13, 12, 3, 2, 9, 70)])


def _conv(shape):
    n, ih, iw, f, s, cin, cout = shape
    return ConvProblem(ih=ih, iw=iw, fh=f, fw=f, s=s, cin=cin, cout=cout,
                       n=n)


# (kind, shape) -> the OS tile's pixels, channels, CTAs (split parts
# included), ring bytes and split: the first of conv2d_df.OS_TILES whose
# CTAs give the card's 132 SMs two each (bf16: one), integers splitting k
# as far as that needs (up to 8 parts of at least 5 steps), else the
# narrowest.
OS_PLANS = {
    ('int8', (1, 56, 56, 3, 1, 64, 64)): (32, 32, 184, 20480, 1),
    ('int8', (1, 56, 56, 3, 2, 64, 128)): (32, 32, 92, 20480, 1),
    ('int8', (1, 28, 28, 3, 1, 128, 128)): (32, 32, 264, 20480, 3),
    ('int8', (1, 28, 28, 3, 2, 128, 256)): (32, 32, 144, 20480, 3),
    ('int8', (1, 14, 14, 3, 1, 256, 256)): (32, 32, 280, 20480, 7),
    ('int8', (1, 14, 14, 3, 2, 256, 512)): (32, 32, 224, 20480, 7),
    ('int8', (1, 7, 7, 3, 1, 512, 512)): (32, 32, 128, 20480, 8),
    ('int8', (1, 56, 56, 3, 1, 256, 256)): (128, 64, 276, 65536, 3),
    ('int8', (1, 56, 56, 3, 1, 256, 512)): (128, 64, 368, 65536, 2),
    ('int8', (1, 28, 28, 3, 1, 512, 512)): (128, 64, 288, 65536, 6),
    ('int8', (1, 14, 14, 3, 1, 512, 512)): (32, 32, 320, 20480, 4),
    ('int8', (1, 9, 8, 3, 1, 5, 6)): (32, 32, 2, 20480, 1),
    ('int8', (2, 11, 10, 3, 2, 7, 10)): (32, 32, 2, 20480, 1),
    ('int8', (1, 14, 13, 3, 1, 20, 70)): (32, 32, 15, 20480, 1),
    ('int8', (2, 13, 12, 3, 2, 9, 70)): (32, 32, 6, 20480, 1),
    ('packed4', (1, 56, 56, 3, 1, 64, 64)): (32, 32, 184, 17408, 1),
    ('packed4', (1, 56, 56, 3, 2, 64, 128)): (32, 32, 92, 17408, 1),
    ('packed4', (1, 28, 28, 3, 1, 128, 128)): (32, 32, 264, 17408, 3),
    ('packed4', (1, 28, 28, 3, 2, 128, 256)): (32, 32, 144, 17408, 3),
    ('packed4', (1, 14, 14, 3, 1, 256, 256)): (32, 32, 280, 17408, 7),
    ('packed4', (1, 14, 14, 3, 2, 256, 512)): (32, 32, 224, 17408, 7),
    ('packed4', (1, 7, 7, 3, 1, 512, 512)): (32, 32, 128, 17408, 8),
    ('packed4', (1, 56, 56, 3, 1, 256, 256)): (128, 64, 276, 58368, 3),
    ('packed4', (1, 56, 56, 3, 1, 256, 512)): (128, 64, 368, 58368, 2),
    ('packed4', (1, 28, 28, 3, 1, 512, 512)): (128, 64, 288, 58368, 6),
    ('packed4', (1, 14, 14, 3, 1, 512, 512)): (32, 32, 320, 17408, 4),
    ('packed4', (1, 9, 8, 3, 1, 5, 6)): (32, 32, 2, 17408, 1),
    ('packed4', (2, 11, 10, 3, 2, 7, 10)): (32, 32, 2, 17408, 1),
    ('packed4', (1, 14, 13, 3, 1, 20, 70)): (32, 32, 15, 17408, 1),
    ('packed4', (2, 13, 12, 3, 2, 9, 70)): (32, 32, 6, 17408, 1),
    ('packed5', (1, 56, 56, 3, 1, 64, 64)): (32, 32, 184, 18688, 1),
    ('packed5', (1, 56, 56, 3, 2, 64, 128)): (32, 32, 92, 18688, 1),
    ('packed5', (1, 28, 28, 3, 1, 128, 128)): (32, 32, 264, 18688, 3),
    ('packed5', (1, 28, 28, 3, 2, 128, 256)): (32, 32, 144, 18688, 3),
    ('packed5', (1, 14, 14, 3, 1, 256, 256)): (32, 32, 280, 18688, 7),
    ('packed5', (1, 14, 14, 3, 2, 256, 512)): (32, 32, 224, 18688, 7),
    ('packed5', (1, 7, 7, 3, 1, 512, 512)): (32, 32, 128, 18688, 8),
    ('packed5', (1, 56, 56, 3, 1, 256, 256)): (128, 64, 276, 60672, 3),
    ('packed5', (1, 56, 56, 3, 1, 256, 512)): (128, 64, 368, 60672, 2),
    ('packed5', (1, 28, 28, 3, 1, 512, 512)): (128, 64, 288, 60672, 6),
    ('packed5', (1, 14, 14, 3, 1, 512, 512)): (32, 32, 320, 18688, 4),
    ('packed5', (1, 9, 8, 3, 1, 5, 6)): (32, 32, 2, 18688, 1),
    ('packed5', (2, 11, 10, 3, 2, 7, 10)): (32, 32, 2, 18688, 1),
    ('packed5', (1, 14, 13, 3, 1, 20, 70)): (32, 32, 15, 18688, 1),
    ('packed5', (2, 13, 12, 3, 2, 9, 70)): (32, 32, 6, 18688, 1),
    ('bf16', (1, 56, 56, 3, 1, 64, 64)): (32, 32, 184, 38912, 1),
    ('bf16', (1, 56, 56, 3, 2, 64, 128)): (32, 32, 92, 38912, 1),
    ('bf16', (1, 28, 28, 3, 1, 128, 128)): (32, 32, 88, 38912, 1),
    ('bf16', (1, 28, 28, 3, 2, 128, 256)): (32, 32, 48, 38912, 1),
    ('bf16', (1, 14, 14, 3, 1, 256, 256)): (32, 32, 40, 38912, 1),
    ('bf16', (1, 14, 14, 3, 2, 256, 512)): (32, 32, 32, 38912, 1),
    ('bf16', (1, 7, 7, 3, 1, 512, 512)): (32, 32, 16, 38912, 1),
    ('bf16', (1, 56, 56, 3, 1, 256, 256)): (64, 64, 184, 73728, 1),
    ('bf16', (1, 56, 56, 3, 1, 256, 512)): (128, 64, 184, 82944, 1),
    ('bf16', (1, 28, 28, 3, 1, 512, 512)): (32, 32, 352, 38912, 1),
    ('bf16', (1, 14, 14, 3, 1, 512, 512)): (32, 32, 80, 38912, 1),
    ('bf16', (1, 9, 8, 3, 1, 5, 6)): (32, 32, 2, 38912, 1),
    ('bf16', (2, 11, 10, 3, 2, 7, 10)): (32, 32, 2, 38912, 1),
    ('bf16', (1, 14, 13, 3, 1, 20, 70)): (32, 32, 15, 38912, 1),
    ('bf16', (2, 13, 12, 3, 2, 9, 70)): (32, 32, 6, 38912, 1),
}
WALK_PLANS = {
    ('int8', (1, 56, 56, 3, 1, 64, 64)): ((1, 54272), (1, 218112)),
    ('int8', (1, 56, 56, 3, 2, 64, 128)): ((2, 54272), (1, 218112)),
    ('int8', (1, 28, 28, 3, 1, 128, 128)): ((2, 91136), (1, 117760)),
    ('int8', (1, 28, 28, 3, 2, 128, 256)): ((4, 91136), (1, 117760)),
    ('int8', (1, 14, 14, 3, 1, 256, 256)): ((4, 164864), (1, 67584)),
    ('int8', (1, 14, 14, 3, 2, 256, 512)): ((8, 164864), (1, 67584)),
    ('int8', (1, 7, 7, 3, 1, 512, 512)): (None, (1, 42496)),
    ('int8', (1, 56, 56, 3, 1, 256, 256)): ((4, 164864), None),
    ('int8', (1, 56, 56, 3, 1, 256, 512)): ((8, 164864), None),
    ('int8', (1, 28, 28, 3, 1, 512, 512)): (None, None),
    ('int8', (1, 14, 14, 3, 1, 512, 512)): (None, (1, 117760)),
    ('int8', (1, 9, 8, 3, 1, 5, 6)): ((1, 21504), (1, 17776)),
    ('int8', (2, 11, 10, 3, 2, 7, 10)): ((1, 21504), (2, 18192)),
    ('int8', (1, 14, 13, 3, 1, 20, 70)): ((2, 29696), (1, 21056)),
    ('int8', (2, 13, 12, 3, 2, 9, 70)): ((2, 23552), (2, 18816)),
    ('packed4', (1, 56, 56, 3, 1, 64, 64)): ((1, 35840), (1, 218112)),
    ('packed4', (1, 56, 56, 3, 2, 64, 128)): ((2, 35840), (1, 218112)),
    ('packed4', (1, 28, 28, 3, 1, 128, 128)): ((2, 54272), (1, 117760)),
    ('packed4', (1, 28, 28, 3, 2, 128, 256)): ((4, 54272), (1, 117760)),
    ('packed4', (1, 14, 14, 3, 1, 256, 256)): ((4, 91136), (1, 67584)),
    ('packed4', (1, 14, 14, 3, 2, 256, 512)): ((8, 91136), (1, 67584)),
    ('packed4', (1, 7, 7, 3, 1, 512, 512)): ((8, 164864), (1, 42496)),
    ('packed4', (1, 56, 56, 3, 1, 256, 256)): ((4, 91136), None),
    ('packed4', (1, 56, 56, 3, 1, 256, 512)): ((8, 91136), None),
    ('packed4', (1, 28, 28, 3, 1, 512, 512)): ((8, 164864), None),
    ('packed4', (1, 14, 14, 3, 1, 512, 512)): ((8, 164864), (1, 117760)),
    ('packed4', (1, 9, 8, 3, 1, 5, 6)): ((1, 26624), (1, 17776)),
    ('packed4', (2, 11, 10, 3, 2, 7, 10)): ((1, 26624), (2, 18192)),
    ('packed4', (1, 14, 13, 3, 1, 20, 70)): ((2, 26624), (1, 21056)),
    ('packed4', (2, 13, 12, 3, 2, 9, 70)): ((2, 26624), (2, 18816)),
    ('packed5', (1, 56, 56, 3, 1, 64, 64)): ((1, 40448), (1, 218112)),
    ('packed5', (1, 56, 56, 3, 2, 64, 128)): ((2, 40448), (1, 218112)),
    ('packed5', (1, 28, 28, 3, 1, 128, 128)): ((2, 63488), (1, 117760)),
    ('packed5', (1, 28, 28, 3, 2, 128, 256)): ((4, 63488), (1, 117760)),
    ('packed5', (1, 14, 14, 3, 1, 256, 256)): ((4, 109568), (1, 67584)),
    ('packed5', (1, 14, 14, 3, 2, 256, 512)): ((8, 109568), (1, 67584)),
    ('packed5', (1, 7, 7, 3, 1, 512, 512)): ((8, 201728), (1, 42496)),
    ('packed5', (1, 56, 56, 3, 1, 256, 256)): ((4, 109568), None),
    ('packed5', (1, 56, 56, 3, 1, 256, 512)): ((8, 109568), None),
    ('packed5', (1, 28, 28, 3, 1, 512, 512)): ((8, 201728), None),
    ('packed5', (1, 14, 14, 3, 1, 512, 512)): ((8, 201728), (1, 117760)),
    ('packed5', (1, 9, 8, 3, 1, 5, 6)): ((1, 28928), (1, 17776)),
    ('packed5', (2, 11, 10, 3, 2, 7, 10)): ((1, 28928), (2, 18192)),
    ('packed5', (1, 14, 13, 3, 1, 20, 70)): ((2, 28928), (1, 21056)),
    ('packed5', (2, 13, 12, 3, 2, 9, 70)): ((2, 28928), (2, 18816)),
    ('bf16', (1, 56, 56, 3, 1, 64, 64)): ((1, 91136), None),
    ('bf16', (1, 56, 56, 3, 2, 64, 128)): ((2, 91136), None),
    ('bf16', (1, 28, 28, 3, 1, 128, 128)): ((2, 164864), (1, 218112)),
    ('bf16', (1, 28, 28, 3, 2, 128, 256)): ((4, 164864), (1, 218112)),
    ('bf16', (1, 14, 14, 3, 1, 256, 256)): (None, (1, 117760)),
    ('bf16', (1, 14, 14, 3, 2, 256, 512)): (None, (1, 117760)),
    ('bf16', (1, 7, 7, 3, 1, 512, 512)): (None, (1, 67584)),
    ('bf16', (1, 56, 56, 3, 1, 256, 256)): (None, None),
    ('bf16', (1, 56, 56, 3, 1, 256, 512)): (None, None),
    ('bf16', (1, 28, 28, 3, 1, 512, 512)): (None, None),
    ('bf16', (1, 14, 14, 3, 1, 512, 512)): (None, (1, 218112)),
    ('bf16', (1, 9, 8, 3, 1, 5, 6)): ((1, 25600), (1, 18128)),
    ('bf16', (2, 11, 10, 3, 2, 7, 10)): ((1, 25600), (2, 18960)),
    ('bf16', (1, 14, 13, 3, 1, 20, 70)): ((2, 41984), (1, 24688)),
    ('bf16', (2, 13, 12, 3, 2, 9, 70)): ((2, 29696), (2, 20224)),
}


@pytest.mark.parametrize("case", sorted(OS_PLANS), ids=str)
def test_os_plans_name_the_tensor_core_tile(case):
    kind, shape = case
    dtype, bits = KINDS[kind]
    bm, bn, ctas, smem, split = OS_PLANS[case]
    p = conv2d_df.plan(SPECS["os"], _conv(shape), dtype, bits)
    tc = "bf16" if kind == "bf16" else "int8"
    assert p.kernel == "conv2d" and p.args == (0,) and p.resident == {}
    assert p.tile_kernel == f"conv2d_os_{'bf16' if tc == 'bf16' else 'i8'}"
    assert (p.tile[0], p.tile[2], p.ctas, p.smem_bytes, p.split) == \
        (bm, bn, ctas, smem, split)
    assert (bm, p.tile[1], bn) in [t for t, _ in conv2d_df.OS_TILES[tc]]
    target = 132 if kind == "bf16" else 2 * 132
    assert split == 1 or (kind != "bf16" and ctas // split < target)
    assert ctas >= target or (bm, bn) == (32, 32)
    assert f"{tc} tensor cores" in p.walk


@pytest.mark.parametrize("case", sorted(WALK_PLANS), ids=str)
def test_walk_plans_keep_their_grid_and_bytes(case):
    """WS and IS keep a CTA per channel tile or per image and the shared
    memory the CUDA-core walk took (its staging beside the resident
    operand): the tensor-core rings fit in ``TILE_BYTES``."""
    kind, shape = case
    dtype, bits = KINDS[kind]
    tc = "bf16" if kind == "bf16" else "i8"
    for anchor, want in zip(("ws", "is"), WALK_PLANS[case]):
        if want is None:
            with pytest.raises(ValueError, match="needs"):
                conv2d_df.plan(SPECS[anchor], _conv(shape), dtype, bits)
            continue
        p = conv2d_df.plan(SPECS[anchor], _conv(shape), dtype, bits)
        assert (p.ctas, p.smem_bytes) == want
        assert p.smem_bytes == conv2d_df.TILE_BYTES + sum(p.resident.values())
        assert p.tile_kernel == f"conv2d_{anchor}_{tc}" and p.split == 1


def test_float32_keeps_the_cuda_core_walk():
    for shape, name in itertools.product(SHAPES, SPECS):
        try:
            p = conv2d_df.plan(SPECS[name], _conv(shape), torch.float32)
        except ValueError:
            continue
        assert p.tile_kernel is None and p.split is None
        assert p.tile == conv2d_df.BLOCK


@pytest.mark.parametrize("tc", ["int8", "bf16"])
def test_walk_rings_fit_the_staging_bytes(tc):
    """What lets the walks keep their feasibility: each ring (A, and B
    where it streams; packed B at 5 bits, the widest) fits
    ``TILE_BYTES``."""
    for anchor in (WS, IS):
        (bm, bk, bn), stages = conv2d_df.WALK_TILES[(tc, anchor)]
        if tc == "int8":
            a = bm * bk
            b = max(bk * bn, (bk // 8 + bk // 32) * (bn + 8) * 4)
        else:
            a, b = bm * (bk + 8) * 2, bk * (bn + 8) * 2
        ring = stages * (a + (b if anchor == IS else 0))
        assert ring <= conv2d_df.TILE_BYTES, (tc, anchor, ring)


# Feasibility per anchor and kind over SHAPES, from the planner before the
# tensor-core tiles ("1" feasible), then the sha256 of its refusal messages
# in this order (anchor, kind, shape); float32 included.
FEASIBLE = {
    "os": {"float32": "111111111111111", "bfloat16": "111111111111111",
           "int8": "111111111111111", "packed4": "111111111111111",
           "packed5": "111111111111111"},
    "ws": {"float32": "110000000001111", "bfloat16": "111100000001111",
           "int8": "111111011001111", "packed4": "111111111111111",
           "packed5": "111111111111111"},
    "is": {"float32": "000011100001111", "bfloat16": "001111100011111",
           "int8": "111111100011111", "packed4": "111111100011111",
           "packed5": "111111100011111"},
}
REFUSALS_SHA256 = \
    "40e24b78e00d71f8ca582f7cbbc9fc6d7e6aef480db3e1b7d5ec7a0b4ea104ac"
FEAS_KINDS = {"float32": (torch.float32, None),
              "bfloat16": (torch.bfloat16, None), "int8": (torch.int8, None),
              "packed4": (torch.int8, 4), "packed5": (torch.int8, 5)}


def test_feasibility_is_the_planners_before_the_tensor_core_tiles():
    digest = hashlib.sha256()
    for name, spec in SPECS.items():
        for kind, (dtype, bits) in FEAS_KINDS.items():
            got = ""
            for shape in SHAPES:
                try:
                    conv2d_df.plan(spec, _conv(shape), dtype, bits)
                except ValueError as err:
                    got += "0"
                    digest.update(str(err).encode())
                    continue
                got += "1"
            assert got == FEASIBLE[name][kind], (name, kind)
    assert digest.hexdigest() == REFUSALS_SHA256


def test_tile_keys_are_registered_and_counted():
    regs = registered_kernels()
    assert _build.TILE_LIBRARIES["conv2d"] == _build.CONV_TILES
    assert set(conv2d_df.TILE_KERNELS.values()) == set(_build.CONV_TILES)
    for key in _build.CONV_TILES:
        assert key in _build.LAUNCHES
        assert regs[key].source.endswith("csrc/conv_tc.cuh")
        assert regs[key].replaces == regs["conv2d"].replaces
    assert "conv_tc.cuh" in _build.HEADERS


@pytest.mark.parametrize("code", range(len(_build.CONV_TILES) + 1))
def test_launch_counts_the_tile_and_split_the_kernel_reports(monkeypatch,
                                                             code):
    class Lib:
        @staticmethod
        def conv2d(*args):
            took, stream = args[-2:]
            took[0], took[1], took[2] = code, 20480, 128
            took[3] = 4 if code else 0
            return 0

    monkeypatch.setattr(_build, "library", lambda name: Lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    got = _build.launch("conv2d", 1, 2)
    tile = _build.CONV_TILES[code - 1] if code else None
    assert got == (None if tile is None else (tile, 20480, 128, 4))
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == \
        {"conv2d": 1, **({tile: 1} if tile else {})}


def _fake_launch(monkeypatch, report):
    """Route conv2d_df's launch to an entry point that reports ``report``
    (meta tensors stand in for the card's)."""
    seen = {}

    class Lib:
        @staticmethod
        def conv2d(*args):
            seen["args"] = args
            took = args[-2]
            for i, v in enumerate(report(args)):
                took[i] = v
            return 0

    monkeypatch.setattr(_build, "library", lambda name: Lib)
    monkeypatch.setattr(_build, "require_cuda", lambda *t: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    return seen


@pytest.mark.parametrize("drift", ["tile", "smem", "ctas", "split", "none"])
def test_a_launch_whose_report_differs_from_its_plan_raises(monkeypatch,
                                                            drift):
    shape = (1, 14, 14, 3, 1, 256, 256)       # int8 OS: split 3
    conv = _conv(shape)
    p = conv2d_df.plan(SPECS["os"], conv, torch.int8)
    assert p.split > 1
    codes = {k: i + 1 for i, k in enumerate(_build.CONV_TILES)}
    good = [codes[p.tile_kernel], p.smem_bytes, p.ctas, p.split]
    bad = {"tile": [codes["conv2d_os_bf16"]] + good[1:],
           "smem": [good[0], good[1] + 16] + good[2:],
           "ctas": good[:2] + [good[2] + 1, good[3]],
           "split": good[:3] + [good[3] + 1],
           "none": [0, 0, 0, 0]}[drift]
    x = torch.empty((1, 14, 14, 256), dtype=torch.int8, device="meta")
    w = torch.empty((3, 3, 256, 256), dtype=torch.int8, device="meta")
    seen = _fake_launch(monkeypatch, lambda args: good)
    out = conv2d_df.conv2d_df(x, w, 1, SPECS["os"])
    assert out.shape == (1, 12, 12, 256) and out.dtype == torch.int32
    # the split's workspace and counters went to the entry point
    assert seen["args"][-5] == p.ctas * p.tile[0] * p.tile[2]
    assert seen["args"][-3] >= p.ctas // p.split
    assert _build.LAUNCHES["conv2d_os_i8"] == 1
    _fake_launch(monkeypatch, lambda args: bad)
    with pytest.raises(_build.KernelError, match="plan says"):
        conv2d_df.conv2d_df(x, w, 1, SPECS["os"])


# ---------------------------------------------------------------------------
# Design notes: csrc/conv_tc.cuh's A gather and split merge in numpy.
# ---------------------------------------------------------------------------
def _pixel_base(q, conv):
    p = conv.oh * conv.ow
    if q >= p:
        return -1
    return ((q // conv.ow) * conv.s * conv.iw + (q % conv.ow) * conv.s) \
        * conv.cin


def _window_offset(kk, conv, cr):
    tap, c = divmod(kk, cr)
    if tap >= conv.fh * conv.fw or c >= conv.cin:
        return -1
    return ((tap // conv.fw) * conv.iw + tap % conv.fw) * conv.cin + c


def _gathered(img, conv, cr, tbm, tbk, epu, vec):
    """A as the kernel's k steps build it, tile by tile: 16-byte units of
    ``epu`` elements (vec) or single elements, zeros where the offset or
    the pixel is out."""
    p, k = conv.oh * conv.ow, conv.fh * conv.fw * cr
    steps = -(-(-(-k // 32) * 32) // tbk)
    tiles = -(-p // tbm)
    a = np.zeros((tiles * tbm, steps * tbk), img.dtype)
    flat = np.concatenate([img.reshape(-1), np.zeros(epu, img.dtype)])
    for t, s in itertools.product(range(tiles), range(steps)):
        k0 = s * tbk
        for r in range(tbm):
            q = t * tbm + r
            b = _pixel_base(q, conv)
            width = epu if vec else 1
            for col in range(0, tbk, width):
                off = _window_offset(k0 + col, conv, cr)
                if off >= 0 and b >= 0:
                    a[q, k0 + col:k0 + col + width] = \
                        flat[b + off:b + off + width]
    return a[:p, :k]


def _im2col(img, conv, cr):
    """Row (oy, ox), column (ky, kx, c < cr): the image there, 0 for a
    pad channel c >= Cin."""
    cols = np.zeros((conv.oh, conv.ow, conv.fh, conv.fw, cr), img.dtype)
    for ky, kx in itertools.product(range(conv.fh), range(conv.fw)):
        cols[:, :, ky, kx, :conv.cin] = img[
            ky:ky + conv.s * (conv.oh - 1) + 1:conv.s,
            kx:kx + conv.s * (conv.ow - 1) + 1:conv.s]
    return cols.reshape(conv.oh * conv.ow, -1)


# The tiles the gather runs in (pixels, k step, elements of a 16-byte
# unit): int8 and bf16 OS (32 x 64, 16 or 8), the int8 walks (64 x 32, 16),
# bf16 IS (64 x 16, 8).
GATHER_TILES = {"int8": (32, 64, 16), "bf16": (32, 64, 8),
                "int8 walk": (64, 32, 16), "bf16 is": (64, 16, 8)}


@pytest.mark.parametrize("tile", sorted(GATHER_TILES))
@pytest.mark.parametrize("cin,packed", [(5, False), (20, False), (9, True),
                                        (32, False), (64, False),
                                        (48, True), (20, True)])
@pytest.mark.parametrize("f,s", [(3, 1), (3, 2), (2, 1)])
def test_the_a_gather_is_an_im2col(tile, cin, packed, f, s):
    """The (pixel, k step) -> image offset map equals an im2col of the
    image: by 16-byte units when Cin is a whole number of them (else a
    unit may cross a row of taps or into the pad channels, so the kernel
    stores elements), and
    element by element always; pixels past the image, indices past K and
    pad channels read 0."""
    tbm, tbk, epu = GATHER_TILES[tile]
    ih, iw = 9, 11
    conv = ConvProblem(ih=ih, iw=iw, fh=f, fw=f, s=s, cin=cin, cout=8)
    cr = -(-cin // 32) * 32 if packed else cin
    img = np.random.default_rng(cin * 7 + s).integers(
        -127, 128, (ih, iw, cin)).astype(np.int16)
    want = _im2col(img, conv, cr)
    np.testing.assert_array_equal(
        _gathered(img, conv, cr, tbm, tbk, epu, vec=False), want)
    units = _gathered(img, conv, cr, tbm, tbk, epu, vec=True)
    if cin % epu == 0:
        np.testing.assert_array_equal(units, want)
    elif f == 3:        # a unit crosses a row of taps or into the pad
        assert not np.array_equal(units, want)


@pytest.mark.parametrize("split", [2, 3, 4, 8])
def test_the_integer_split_merge_is_exact(split):
    """Each part sums its own k steps in int32 and the last CTA to arrive
    adds the others' to its own: whatever the arrival order, the result
    is the whole sum, and every part and the total fit int32 at the
    extreme operands (|x|, |w| <= 128 at K = 4608).  The workspace slot
    ((tile * split + part) * R + i) * NT + thread is one per value."""
    rng = np.random.default_rng(split)
    tbk, k = 64, 4608
    steps = -(-k // tbk)
    per = -(-steps // split)
    a = rng.integers(-128, 128, (16, k))
    b = rng.integers(-128, 128, (k, 8))
    a[0], b[:, 0] = -128, -128          # the largest |sum|
    parts = [a[:, z * per * tbk:(z + 1) * per * tbk]
             @ b[z * per * tbk:(z + 1) * per * tbk] for z in range(split)]
    for part in parts + [a @ b]:
        assert np.abs(part).max() < 2 ** 31
    for last in range(split):
        order = rng.permutation(split)
        got = parts[last].astype(np.int32)
        for z in order:
            if z != last:
                got = got + parts[z].astype(np.int32)
        np.testing.assert_array_equal(got, a @ b)
    tiles, r, nt = 3, 8, 128
    slots = [((t * split + z) * r + i) * nt + th for t, z, i, th in
             itertools.product(range(tiles), range(split), range(r),
                               range(nt))]
    assert sorted(slots) == list(range(tiles * split * r * nt))


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B8's tensor-core tiles run only there")
    return torch.device("cuda")


B1_TOL = dict(atol=1e-3, rtol=1e-3)
# Small shapes and ragged ones, then a layer of each OS tile and split.
CARD_SHAPES = [(1, 9, 8, 3, 1, 5, 6), (2, 11, 10, 3, 2, 7, 10),
               (1, 14, 13, 3, 1, 20, 70), (2, 13, 12, 3, 2, 9, 70),
               (2, 12, 12, 3, 1, 32, 48), (1, 15, 15, 3, 2, 64, 96)]
LAYER_SHAPES = [(1, 56, 56, 3, 1, 64, 64), (1, 14, 14, 3, 1, 256, 256),
                (1, 7, 7, 3, 1, 512, 512), (1, 56, 56, 3, 1, 256, 256),
                (1, 56, 56, 3, 1, 256, 512)]


def _epilogues(gen, dev, n, oh, ow, cout):
    return {
        "raw": {},
        "scale": dict(scale=torch.rand((cout,), generator=gen, device=dev)
                      * 1e-3 + 1e-4),
        "all": dict(scale=torch.rand((cout,), generator=gen, device=dev)
                    * 1e-3 + 1e-4,
                    bias=torch.randn((cout,), generator=gen, device=dev),
                    residual=torch.randn((n, oh, ow, cout), generator=gen,
                                         device=dev),
                    activation="relu"),
    }


def _run_anchors(label, call, want, bitwise, plans):
    base = None
    for anchor, spec in SPECS.items():
        try:
            p = plans(spec)
        except ValueError:
            with pytest.raises(ValueError):
                call(spec)
            continue
        before = _build.LAUNCHES[p.tile_kernel]
        got = call(spec)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[p.tile_kernel] == before + 1, (label, anchor)
        if bitwise:
            assert torch.equal(got, want), (label, anchor)
        else:
            torch.testing.assert_close(got, want, **B1_TOL)
        if base is not None:
            assert torch.equal(got, base), (label, anchor, "differs from OS")
        base = got


@pytest.mark.card
@pytest.mark.parametrize("shape", CARD_SHAPES + LAYER_SHAPES, ids=str)
def test_int8_conv_on_the_card(card, shape):
    n, ih, iw, f, s, cin, cout = shape
    conv = _conv(shape)
    gen = torch.Generator(device=card).manual_seed(sum(shape))
    x = torch.randint(-127, 128, (n, ih, iw, cin), generator=gen,
                      device=card, dtype=torch.int8)
    w = torch.randint(-127, 128, (f, f, cin, cout), generator=gen,
                      device=card, dtype=torch.int8)
    for what, epi in _epilogues(gen, card, n, conv.oh, conv.ow,
                                cout).items():
        if not epi:
            want = ref.conv2d_ref(x, w, s)
            call = lambda spec: ops.conv2d(x, w, s, spec=spec)  # noqa: E731
        else:
            scale = epi["scale"].reshape(1, -1)
            want = ref.conv2d_fused_ref(
                x, w, s, scale=scale,
                bias=None if "bias" not in epi else epi["bias"].reshape(1, -1),
                residual=epi.get("residual"), activation=epi.get("activation"))
            call = lambda spec, epi=epi: ops.conv2d_fused(  # noqa: E731
                x, w, s, spec=spec, **epi)
        _run_anchors(f"{shape} int8 {what}", call, want, True,
                     lambda spec: conv2d_df.plan(spec, conv, torch.int8))


@pytest.mark.card
@pytest.mark.parametrize("bits", [4, 5])
@pytest.mark.parametrize("shape", CARD_SHAPES + LAYER_SHAPES[:3], ids=str)
def test_packed_conv_on_the_card(card, shape, bits):
    n, ih, iw, f, s, cin, cout = shape
    conv = _conv(shape)
    gen = torch.Generator(device=card).manual_seed(sum(shape) + bits)
    xq = torch.randint(-127, 128, (n, ih, iw, cin), generator=gen,
                       device=card, dtype=torch.int8)
    w = torch.randn((f, f, cin, cout), generator=gen, device=card)
    w[0, 1, min(3, cin - 1), :] *= 30.0          # outlier rows the image hits
    w[f - 1, 0, cin - 1, :] *= 25.0
    pcw = pack.pack_conv_weights(w, bits)
    assert int((pcw.outlier_idx >= 0).sum()) >= 1
    x_scale = torch.tensor(0.02, device=card)
    bias = torch.randn((cout,), generator=gen, device=card)
    residual = torch.randn((n, conv.oh, conv.ow, cout), generator=gen,
                           device=card)
    runs = {
        "dequant": (lambda spec: ops.conv2d_packed(xq, pcw, s,
                                                   x_scale=x_scale,
                                                   spec=spec),
                    ref.conv2d_packed_ref(xq, pcw, s,
                                          x_scale=x_scale.reshape(1, 1))),
        "all": (lambda spec: ops.conv2d_packed_fused(
            xq, pcw, s, x_scale=x_scale, bias=bias, residual=residual,
            activation="relu", spec=spec),
            ref.conv2d_packed_ref(xq, pcw, s, x_scale=x_scale.reshape(1, 1),
                                  bias=bias.reshape(1, -1),
                                  residual=residual, activation="relu")),
    }
    for what, (call, want) in runs.items():
        _run_anchors(f"{shape} packed{bits} {what}", call, want, True,
                     lambda spec: conv2d_df.plan(spec, conv, torch.int8,
                                                 bits))


@pytest.mark.card
@pytest.mark.parametrize("shape", CARD_SHAPES + LAYER_SHAPES, ids=str)
def test_bf16_conv_on_the_card(card, shape):
    n, ih, iw, f, s, cin, cout = shape
    conv = _conv(shape)
    gen = torch.Generator(device=card).manual_seed(sum(shape) + 1)
    x = torch.randn((n, ih, iw, cin), generator=gen,
                    device=card).to(torch.bfloat16)
    w = (torch.randn((f, f, cin, cout), generator=gen, device=card)
         * (f * f * cin) ** -0.5).to(torch.bfloat16)
    epi = dict(scale=torch.rand((cout,), generator=gen, device=card) + 0.5,
               bias=torch.randn((cout,), generator=gen, device=card),
               residual=torch.randn((n, conv.oh, conv.ow, cout),
                                    generator=gen, device=card),
               activation="gelu")
    runs = {"raw": (lambda spec: ops.conv2d(x, w, s, spec=spec),
                    ref.conv2d_ref(x, w, s)),
            "all": (lambda spec: ops.conv2d_fused(x, w, s, spec=spec, **epi),
                    ref.conv2d_fused_ref(
                        x, w, s, scale=epi["scale"].reshape(1, -1),
                        bias=epi["bias"].reshape(1, -1),
                        residual=epi["residual"], activation="gelu"))}
    for what, (call, want) in runs.items():
        _run_anchors(f"{shape} bf16 {what}", call, want, False,
                     lambda spec: conv2d_df.plan(spec, conv, torch.bfloat16))
    # a bf16 output is the f32 result rounded once
    f32 = ops.conv2d(x, w, s)
    assert torch.equal(ops.conv2d(x, w, s, out_dtype=torch.bfloat16),
                       f32.to(torch.bfloat16))
