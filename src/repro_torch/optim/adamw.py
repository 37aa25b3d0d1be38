"""AdamW with decoupled weight decay, float32 moments, global-norm
clipping, updating the parameters in place.

The port's counterpart of ``repro/optim/adamw.py``, with its arithmetic:
the gradients scaled by ``min(1, clip_norm / (global_norm + 1e-12))``,
the moments kept in float32 (or ``moment_dtype``: bfloat16 halves their
bytes, the arithmetic stays float32), the bias corrections ``1 - b**step``
and ``delta = mh / (sqrt(vh) + eps) + weight_decay * p``, the new
parameter computed in float32 and cast back to the parameter's dtype.
Every floating-point tensor leaf is trained, decay included (no mask, as
in the reference); integer leaves (packed or binary weight planes) are
not.  ``torch.optim.AdamW`` is not used: it decays the parameter before
the Adam step, not inside ``delta``.

Unlike the reference's pure ``update``, this one writes the parameters
and the moments in place under ``torch.no_grad()``: at qwen3-1.7b's full
width a functional update would hold a second copy of 3.4 GB of bf16
parameters and 13.8 GB of float32 moments.  The schedule's rate and the
bias corrections are host numbers; the clip scale stays on the device,
so an update never waits for the card.

Parameter trees are nested dicts; ``leaves`` walks them in sorted key
order (the order ``jax.tree.leaves`` gives), which fixes the order of
the global norm's sum.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

Tree = Dict[str, Any]
Path = Tuple[str, ...]


def leaves(tree: Tree, prefix: Path = ()) -> List[Tuple[Path, torch.Tensor]]:
    """(path, tensor) of every floating-point tensor leaf, in sorted key
    order."""
    out = []
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out += leaves(val, prefix + (key,))
        elif torch.is_tensor(val) and val.is_floating_point():
            out.append((prefix + (key,), val))
    return out


def unflatten(pairs) -> Tree:
    """The nested dict of ``(path, value)`` pairs."""
    tree: Tree = {}
    for path, val in pairs:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    return tree


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (0-d)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for _, x in leaves(tree)))


class AdamWState(NamedTuple):
    step: int                # updates taken
    m: Tree                  # like the trained leaves, ``moment_dtype``
    v: Tree


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr_fn: Callable[[float], float]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"

    def init(self, params: Tree) -> AdamWState:
        dt = getattr(torch, self.moment_dtype)
        # zeros_like keeps a DTensor parameter's placements
        zeros = [(path, torch.zeros_like(p, dtype=dt))
                 for path, p in leaves(params)]
        return AdamWState(0, unflatten(zeros),
                          unflatten((path, torch.zeros_like(z))
                                    for path, z in zeros))

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamWState, params: Tree
               ) -> Tuple[Tree, AdamWState, Dict[str, Any]]:
        """One step: ``params`` and the moments are written in place and
        returned with the new step count.  Metrics: ``grad_norm`` (the
        norm before clipping, a 0-d float32 tensor) and ``lr``."""
        gnorm = global_norm(grads)
        scale = None
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-12), max=1.0)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
        lr = float(self.lr_fn(state.step))
        g_of = dict(leaves(grads))
        m_of, v_of = dict(leaves(state.m)), dict(leaves(state.v))
        for path, p in leaves(params):
            g = g_of[path].float()
            if scale is not None:
                g = g * scale
            m, v = m_of[path], v_of[path]
            mf = m.float().mul_(b1).add_((1 - b1) * g)
            vf = v.float().mul_(b2).add_((1 - b2) * g * g)
            delta = (mf / bc1) / (torch.sqrt(vf / bc2) + self.eps)
            delta += self.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            if mf is not m:          # bf16 moments: float32 copies above
                m.copy_(mf)
                v.copy_(vf)
        return params, AdamWState(step, state.m, state.v), {
            "grad_norm": gnorm, "lr": lr}
