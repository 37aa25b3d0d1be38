"""Train a reduced-config model end to end with the port's fault-tolerant
driver, crash it mid-run and resume.

    PYTHONPATH=src python examples/train_smoke_torch.py [--arch hymba-1.5b]
        [--device cpu]

The twin of ``examples/train_smoke.py`` on ``repro_torch`` (no JAX): the
smoke config of ``--arch`` (any of ``repro_torch.configs.ARCH_NAMES``)
with random weights, on the card unless ``--device cpu`` (the kernels'
plain versions): synthetic step-addressed data, AdamW with the WSD
schedule, checkpoints every 10 steps saved in the background, a crash
injected at ``--crash-at`` (``REPRO_FAIL_AT_STEP``), and a second driver
that resumes from the newest checkpoint and finishes; then the job once
more without the crash, whose parameters the resumed run's must equal
bit for bit (the driver's steps run under deterministic algorithms; on
the card an SSM config's float ``cumsum`` has no deterministic kernel,
so there they may differ in the last bits and the run says so).
Checkpoints go to a temporary directory, removed at the end.
"""
import argparse
import os
import shutil
import tempfile

import torch

from repro_torch import configs
from repro_torch.optim.adamw import leaves
from repro_torch.runtime.driver import TrainDriver, TrainJobConfig
from repro_torch.runtime.health import SimulatedFailure


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b",
                    choices=configs.ARCH_NAMES)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--crash-at", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain PyTorch path")
    args = ap.parse_args()

    cfg = configs.get_smoke(args.arch)
    work = tempfile.mkdtemp(prefix="repro_torch_train_smoke_")

    def job(name: str) -> TrainJobConfig:
        return TrainJobConfig(
            arch=cfg, steps=args.steps, global_batch=4, seq_len=64, lr=3e-3,
            schedule="wsd", ckpt_dir=os.path.join(work, name), ckpt_every=10)

    try:
        print(f"training {cfg.name} for {args.steps} steps "
              f"(crash injected at {args.crash_at})")
        os.environ["REPRO_FAIL_AT_STEP"] = str(args.crash_at)
        try:
            TrainDriver(job("crashed"), device=args.device).run()
        except SimulatedFailure as e:
            print(f"!! {e}: restarting from the checkpoint")
        finally:
            os.environ.pop("REPRO_FAIL_AT_STEP", None)
        driver = TrainDriver(job("crashed"), device=args.device)
        state = driver.run(resume=True)
        print(f"done: step={state.step} final loss={state.last_loss:.4f} "
              f"on {driver.device}; health {driver.health_report()}")
        clean = TrainDriver(job("clean"), device=args.device).run()
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            leaves(state.params), leaves(clean.params)))
        print(f"resumed == uninterrupted, bit for bit: {same}")
        if not same and not (cfg.has_ssm and driver.device.type == "cuda"):
            raise SystemExit(1)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
