"""The training step: gradients, microbatch accumulation, the optimizer.

The port's counterpart of ``repro/train/step.py``.  ``make_train_step``
builds ``train_step(params, opt_state, batch) -> (params, opt_state,
metrics)``: the loss and its gradients (``lm.loss_fn`` under autograd,
every floating-point leaf trained), with ``microbatches`` > 1 the batch's
leading dim split evenly and the gradients summed in float32 and
averaged, as the reference's ``lax.scan`` accumulates them; then
``AdamW.update``, which writes the parameters and moments in place (so
the returned trees are the ones passed in).  PyTorch runs eagerly: the
step is not compiled.  The gradients are taken of detached aliases of
the parameters, so the caller's tensors never have ``requires_grad``
set and a serving path over the same tensors runs as before.  Metrics
are float32 0-d tensors (``loss``, ``nll``, ``aux``, ``grad_norm``) and
the rate ``lr``; reading one as a number waits for the card.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models import lm
from repro_torch.optim.adamw import AdamW, AdamWState, leaves, unflatten

Batch = Dict[str, torch.Tensor]


def make_loss_fn(cfg, remat: str = "dots",
                 aux_weight: float = 0.01) -> Callable:
    def loss(params, batch: Batch):
        return lm.loss_fn(params, batch, cfg, remat=remat,
                          aux_weight=aux_weight)
    return loss


def value_and_grad(loss_fn: Callable, params: Dict[str, Any], batch: Batch
                   ) -> Tuple[torch.Tensor, Dict[str, Any], Dict[str, Any]]:
    """(loss, metrics, gradients) of ``loss_fn(params, batch)``, the
    gradients a tree of the trained leaves in their dtypes (zeros for a
    leaf the loss does not reach, as JAX's are)."""
    trained = leaves(params)
    tracked = {path: p.detach().requires_grad_() for path, p in trained}

    def with_tracked(tree, prefix=()):
        return {k: with_tracked(v, prefix + (k,)) if isinstance(v, dict)
                else tracked.get(prefix + (k,), v) for k, v in tree.items()}

    with torch.enable_grad():
        loss, metrics = loss_fn(with_tracked(params), batch)
        grads = torch.autograd.grad(loss, list(tracked.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(zip(tracked, grads)))


def make_train_step(cfg, optimizer: AdamW, remat: str = "dots",
                    microbatches: int = 1,
                    aux_weight: float = 0.01) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``."""
    loss_fn = make_loss_fn(cfg, remat, aux_weight)

    def accumulated(params, batch: Batch):
        b = next(iter(batch.values())).shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into "
                             f"{microbatches} microbatches")
        size = b // microbatches
        acc, l_sum, metrics = None, None, None
        for i in range(microbatches):
            micro = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            loss, metrics, grads = value_and_grad(loss_fn, params, micro)
            pairs = leaves(grads)
            if acc is None:
                acc = [torch.zeros(g.shape, dtype=torch.float32,
                                   device=g.device) for _, g in pairs]
                l_sum = torch.zeros((), dtype=torch.float32,
                                    device=loss.device)
            for a, (_, g) in zip(acc, pairs):
                a += g.float()
            l_sum = l_sum + loss
        grads = unflatten((path, a / microbatches)
                          for (path, _), a in zip(pairs, acc))
        return l_sum / microbatches, metrics, grads

    def train_step(params, opt_state: AdamWState, batch: Batch):
        if microbatches > 1:
            loss, metrics, grads = accumulated(params, batch)
        else:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, opt_metrics = optimizer.update(grads, opt_state,
                                                          params)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_eval_step(cfg) -> Callable:
    loss_fn = make_loss_fn(cfg, remat="none")

    @torch.no_grad()
    def eval_step(params, batch: Batch):
        loss, metrics = loss_fn(params, batch)
        return {"loss": loss, **metrics}

    return eval_step
