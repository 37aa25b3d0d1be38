"""End-to-end example of the PyTorch port: serve a small model with
batched requests.

    PYTHONPATH=src python examples/serve_batch_torch.py [--device cpu]

The twin of ``examples/serve_batch.py`` on ``repro_torch`` (no JAX): the
smoke config of ``--arch`` (any of ``repro_torch.configs.ARCH_NAMES``:
qwen3-1.7b, minicpm-2b, mistral-nemo-12b, minitron-8b, chameleon-34b,
qwen3-moe-235b-a22b, moonshot-v1-16b-a3b, mamba2-780m, hymba-1.5b)
with random weights, on the card unless ``--device cpu``;
``--kv-cache-dtype int8`` serves it from an int8 KV cache.  ``submit`` returns a ``RequestHandle``; the first
request's tokens are streamed (each ``next()`` steps the continuous
scheduler) and ``drain`` finishes the rest — mixed prompt lengths
welcome (``--ragged``).  ``--batch-loop`` serves the batch through
``Engine.serve`` instead: equal prompt lengths run the batch-synchronous
loop on the slot cache, snapshot by snapshot.  The run ends with the
engine's counters, the scheduler's occupancy and the health ledger.

Resume-after-kill drill: journal to a directory, SIGKILL the loop
mid-decode (the ``kill`` fault kind sends a real SIGKILL), and rerun with
``--resume``: the restarted engine recovers every in-flight request from
the journal and the newest snapshot and finishes with the greedy tokens
the uninterrupted run would have produced:

    REPRO_FAULT_PLAN="serve.decode_step:10:kill" \\
        PYTHONPATH=src python examples/serve_batch_torch.py --device cpu \\
        --batch-loop --journal-dir /tmp/serve-crash --snapshot-every 4
    PYTHONPATH=src python examples/serve_batch_torch.py --device cpu \\
        --journal-dir /tmp/serve-crash --resume
"""
import argparse
import dataclasses
import time

import numpy as np

from repro_torch import configs
from repro_torch.models import lm
from repro_torch.serve.engine import Engine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b",
                    choices=configs.ARCH_NAMES)
    ap.add_argument("--kv-cache-dtype", default=None,
                    choices=("auto", "int8"),
                    help="the KV cache's type (default: the config's)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain PyTorch path")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--ragged", action="store_true",
                    help="randomize prompt lengths (continuous scheduler)")
    ap.add_argument("--batch-loop", action="store_true",
                    help="serve the batch through Engine.serve")
    ap.add_argument("--journal-dir", default=None,
                    help="journal requests and snapshots here; enables "
                         "--resume after a kill")
    ap.add_argument("--snapshot-every", type=int, default=None,
                    help="snapshot cadence in decode steps")
    ap.add_argument("--resume", action="store_true",
                    help="recover and finish journaled requests")
    args = ap.parse_args()

    cfg = configs.get_smoke(args.arch)
    if args.kv_cache_dtype is not None:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=args.kv_cache_dtype)
    params = lm.init_model(cfg, seed=0, device=args.device)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"serving {cfg.name} ({n_params / 1e6:.1f}M params, reduced "
          f"config) on {params['embed']['table'].device}")
    # the paged decode step needs max_len to be a whole number of pages
    max_len = -(-(args.prompt_len + args.new_tokens + 8) // 16) * 16
    engine = Engine(cfg, params, max_len=max_len, device=args.device,
                    journal_dir=args.journal_dir,
                    snapshot_every=args.snapshot_every)

    t0 = time.time()
    if args.resume:
        reqs = engine.restore()
        print(f"restored {len(reqs)} journaled request(s), "
              f"{engine.stats()['recovered']} in flight")
        engine.serve(reqs)
    else:
        rng = np.random.default_rng(0)
        lens = (rng.integers(1, args.prompt_len + 1, args.batch)
                if args.ragged else np.full(args.batch, args.prompt_len))
        reqs = [engine.submit(rng.integers(0, cfg.vocab_size, int(n)).astype(
                    np.int32), args.new_tokens)
                for n in lens]
        if args.batch_loop:
            engine.serve(reqs)
        else:
            # stream the first handle token by token (each next() steps
            # the scheduler), then drain the rest of the batch
            print(f"  req{reqs[0].rid} streaming:", end="", flush=True)
            for tok in reqs[0].tokens():
                print(f" {tok}", end="", flush=True)
            print()
            engine.drain()
    dt = time.time() - t0
    total_new = sum(len(r.out_tokens) for r in reqs)
    print(f"batch={len(reqs)} prompt<={args.prompt_len} "
          f"new={args.new_tokens}: {dt:.2f}s ({total_new / dt:.1f} tok/s "
          f"incl. prefill)")
    for r in reqs:
        print(f"  req{r.rid} [{r.state.value}] prompt={len(r.prompt)}: "
              f"{r.out_tokens[:12]}...")
    stats = engine.stats()
    health = stats.pop("health")
    print(f"engine stats: {stats}")
    print(f"health: {health}")
    print(f"scheduler: {engine.scheduler_report()}")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        elif hasattr(v, "LEAVES"):
            yield from (getattr(v, f) for f in v.LEAVES
                        if getattr(v, f) is not None)
        else:
            yield v


if __name__ == "__main__":
    main()
