"""Serving launcher of the port: continuous batched generation.

Usage (on the card; random weights from ``--seed``, nothing downloaded):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --batch 4 --prompt-len 32 --new-tokens 16

  # the plain PyTorch path on the CPU, at the smoke size:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --smoke --device cpu

Requests go through ``Engine.submit`` and ``drain`` (the continuous
scheduler); ``--ragged`` draws prompt lengths in [1, prompt-len].  The
JAX launcher's ``--journal-dir``, ``--snapshot-every`` and ``--resume``
wait for ROADMAP A5a.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import configs
from repro_torch.models import lm
from repro_torch.serve.engine import Engine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--ragged", action="store_true",
                    help="randomize prompt lengths in [1, prompt-len]")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain PyTorch path")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(
        args.arch)
    params = lm.init_model(cfg, seed=args.seed, device=args.device)
    # the paged path needs max_len to be a whole number of pages (16)
    max_len = -(-(args.prompt_len + args.new_tokens + 8) // 16) * 16
    engine = Engine(cfg, params, max_len=max_len, device=args.device)
    rng = np.random.default_rng(args.seed)
    lens = (rng.integers(1, args.prompt_len + 1, args.batch) if args.ragged
            else np.full(args.batch, args.prompt_len))
    reqs = [engine.submit(rng.integers(0, cfg.vocab_size, int(n)).astype(
                np.int32), args.new_tokens)
            for n in lens]
    engine.drain()
    for r in reqs:
        print(f"  req{r.rid} [{r.state.value}] prompt={len(r.prompt)}: "
              f"{r.out_tokens}")
    stats = engine.stats()
    print(f"engine on {engine.device}: admitted={stats['admitted']} "
          f"completed={stats['completed']} retries={stats['retries']} "
          f"demotions={stats['demotions']} "
          f"degraded_steps={stats['degraded_steps']}")


if __name__ == "__main__":
    main()
