"""Global model-lowering flags.

EXACT_COST_MODE: a dry-run-only switch (``launch/dryrun.py``), the twin
of the reference's.  ``exact_cost_mode()`` sets it and pins every kernel
dispatch site of ``models/layers.py`` onto its plain PyTorch twin
(``layers.forced_backend("torch")``); the flag itself runs the training
loss's cross entropy in one chunk.  The step is then made of ATen
operators alone: ``FlopCounterMode`` counts their FLOPs and
``FakeTensorMode`` runs them on shapes without a fake implementation of
any kernel.  PyTorch runs eagerly, so no loop is undercounted as an XLA
while-loop body is; the mode exists for the counter and the fake
tensors.  Never set at execution time: the plain paths materialize S x S
score buffers.
"""
from __future__ import annotations

import contextlib

EXACT_COST_MODE = False


@contextlib.contextmanager
def exact_cost_mode():
    from repro_torch.models import layers

    global EXACT_COST_MODE
    prev = EXACT_COST_MODE
    EXACT_COST_MODE = True
    try:
        with layers.forced_backend("torch"):
            yield
    finally:
        EXACT_COST_MODE = prev
