"""Serving launcher of the port: continuous batched generation.

Usage (on the card; random weights from ``--seed``, nothing downloaded):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --batch 4 --prompt-len 32 --new-tokens 16

  # the plain PyTorch path on the CPU, at the smoke size:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --smoke --device cpu

  # another dense config, its float32 smoke size (d_head 16) on the card,
  # from an int8 KV cache (codes with per-position scales, the slot cache):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm-2b \
      --smoke --kv-cache-dtype int8

``--arch`` takes every name of ``repro_torch.configs.ARCH_NAMES``
(qwen3-1.7b, minicpm-2b, mistral-nemo-12b, minitron-8b, chameleon-34b,
the MoE decoders qwen3-moe-235b-a22b and moonshot-v1-16b-a3b, the SSM
mamba2-780m and the hybrid hymba-1.5b, which decode off the slot cache
with their SSM state);
``--kv-cache-dtype`` sets the config's ``kv_cache_dtype`` ("auto" follows
the activations; "int8" decodes off the slot cache, no page pool).

Requests go through ``Engine.submit`` and ``drain`` (the continuous
scheduler); ``--ragged`` draws prompt lengths in [1, prompt-len].

Crash-safe serving: with a journal directory every admission, token and
terminal transition is journaled, with engine snapshots every
``--snapshot-every`` decode steps of the batch loop; after a kill,
``--resume`` restores the journal (and the newest snapshot) and finishes
the interrupted requests with the uninterrupted run's greedy tokens:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --smoke --device cpu --journal-dir /tmp/serve-journal
  # ... a SIGKILL mid-decode (REPRO_FAULT_PLAN=serve.decode_step:3:kill),
  # then:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --smoke --device cpu --journal-dir /tmp/serve-journal --resume
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch import configs
from repro_torch.models import lm
from repro_torch.serve.engine import Engine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--kv-cache-dtype", default=None,
                    choices=("auto", "int8"),
                    help="the KV cache's type (default: the config's)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--ragged", action="store_true",
                    help="randomize prompt lengths in [1, prompt-len]")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain PyTorch path")
    ap.add_argument("--journal-dir", default=None,
                    help="journal requests (write-ahead) and snapshots "
                         "under this directory")
    ap.add_argument("--snapshot-every", type=int, default=None,
                    help="engine snapshot cadence in decode steps "
                         "(default: REPRO_SNAPSHOT_EVERY)")
    ap.add_argument("--resume", action="store_true",
                    help="recover the journaled requests after a crash "
                         "and finish serving them")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(
        args.arch)
    if args.kv_cache_dtype is not None:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=args.kv_cache_dtype)
    params = lm.init_model(cfg, seed=args.seed, device=args.device)
    # the paged path needs max_len to be a whole number of pages (16)
    max_len = -(-(args.prompt_len + args.new_tokens + 8) // 16) * 16
    engine = Engine(cfg, params, max_len=max_len, device=args.device,
                    journal_dir=args.journal_dir,
                    snapshot_every=args.snapshot_every)
    if args.resume:
        reqs = engine.restore()
        engine.serve(reqs)
        print(f"resumed {len(reqs)} journaled request(s):")
    else:
        rng = np.random.default_rng(args.seed)
        lens = (rng.integers(1, args.prompt_len + 1, args.batch)
                if args.ragged else np.full(args.batch, args.prompt_len))
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
          f"degraded_steps={stats['degraded_steps']} "
          f"snapshots={stats['snapshots_saved']} "
          f"recovered={stats['recovered']} "
          f"replayed_steps={stats['replayed_steps']}")


if __name__ == "__main__":
    main()
