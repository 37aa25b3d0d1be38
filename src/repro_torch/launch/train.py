"""Training launcher of the port: the fault-tolerant driver end to end.

Usage (on the card; random weights and synthetic data from ``--seed``,
nothing downloaded):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --smoke --steps 50 --batch 8 --seq 128

  # the kernels' plain versions on the CPU, at the smoke size:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --smoke --device cpu --steps 20 --ckpt-dir /tmp/ckpt

  # after a crash (REPRO_FAIL_AT_STEP=<n> injects one), go on from the
  # newest checkpoint:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --smoke --device cpu --steps 20 --ckpt-dir /tmp/ckpt --resume

The reference launcher's flags, plus ``--device``.
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.runtime.driver import TrainDriver, TrainJobConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine",
                    choices=("cosine", "wsd", "const"))
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_torch_ckpt "
                         "under the temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=("none", "dots",
                                                        "full"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain PyTorch path")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(
        args.arch)
    job = TrainJobConfig(
        arch=cfg, steps=args.steps, global_batch=args.batch,
        seq_len=args.seq, lr=args.lr, schedule=args.schedule,
        ckpt_every=args.ckpt_every, microbatches=args.microbatches,
        remat=args.remat, seed=args.seed,
        **({} if args.ckpt_dir is None else {"ckpt_dir": args.ckpt_dir}))
    driver = TrainDriver(job, device=args.device)
    state = driver.run(resume=args.resume)
    print(f"final step={state.step} loss={state.last_loss:.4f} on "
          f"{driver.device}")


if __name__ == "__main__":
    main()
