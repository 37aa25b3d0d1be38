"""On the card: every candidate the explorer offers gives basic OS's bits.

Each dataflow of a GEMM (bf16, int8, packed 4- and 5-bit), a binary GEMM,
a conv (int8, bf16, f32) and an attention (bf16 and int8 K/V, B7 against
B2) that ``core.explorer`` enumerates runs through its public op on the
card, and its output must equal the basic OS candidate's (B2's for
attention) bit for bit: the anchors sum k in B1's order, and B7 folds
with B2's step.  Skipped without a card (decided in the fixture); this
file imports no JAX, so on the card:

    PYTHONPATH=src python -m pytest --noconftest -q -m card \\
        tests/test_torch_explorer_card.py
"""
import pytest
import torch

from repro_torch.core import explorer
from repro_torch.core.dataflow import (AttentionProblem, BinaryProblem,
                                       ConvProblem, GemmProblem, OS)

PROBLEMS = [
    GemmProblem(4, 2048, 6144), GemmProblem(37, 300, 200),
    GemmProblem(200, 6144, 2048), GemmProblem(9, 96, 33, "float32"),
    GemmProblem(4, 2048, 6144, "int8", "float32", "int32", 4),
    GemmProblem(130, 512, 384, "int8", "float32", "int32", 5),
    GemmProblem(70, 256, 96, "int8", "int32", "int32"),
    BinaryProblem(4, 64, 6144, 2048, "int8"),
    BinaryProblem(100, 6, 130, 180),
    ConvProblem(28, 28, 3, 3, 1, 128, 128, out_dtype="float32"),
    ConvProblem(14, 14, 3, 3, 2, 64, 96, in_dtype="bfloat16",
                out_dtype="float32"),
    ConvProblem(9, 11, 3, 3, 1, 5, 7, in_dtype="float32",
                out_dtype="float32"),
    AttentionProblem(16, 200, 200, 128, 2, dtype="bfloat16"),
    AttentionProblem(64, 1, 1024, 128, 2, dtype="bfloat16", kv_dtype="int8"),
    AttentionProblem(16, 128, 1024, 128, 2, dtype="bfloat16",
                     kv_dtype="int8"),
    AttentionProblem(8, 37, 37, 16, 4, dtype="float32"),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("problem", PROBLEMS,
                         ids=[f"{type(p).__name__}{i}"
                              for i, p in enumerate(PROBLEMS)])
def test_every_candidate_equals_basic_os_on_the_card(card, problem):
    cands = explorer.explore(problem, top=99)
    assert cands
    calls = explorer.candidate_calls(problem, [c.spec for c in cands], card)
    base = next(fn for spec, fn in calls if spec.anchor == OS and (
        isinstance(problem, ConvProblem)     # B8's one OS spec
        or all(r.value == "streamed" for _, r in spec.aux)))
    want = base()
    for spec, fn in calls:
        got = fn()
        assert torch.equal(got, want), (problem, spec.name)
