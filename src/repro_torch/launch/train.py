"""The training CLI: the JAX package's `repro.launch.train` on the port.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      --steps 50 --batch 8 --seq 128 --ckpt-dir build/ckpt
  # on the CPU, at the reduced (smoke) config:
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
  # crash/restart drill:
  PYTHONPATH=src python -m repro_torch.launch.train --fail-at 30 ... ; \
  PYTHONPATH=src python -m repro_torch.launch.train ...   # auto-resumes

It prints the JAX package's log lines: every 10 steps the step, loss,
perplexity, gradient norm and tokens per second, and the final step with
the seconds taken.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import ModelRuntime
from repro_torch.training import OptimizerConfig, TrainConfig, Trainer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="failure injection: crash at this step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    tc = TrainConfig(
        optimizer=OptimizerConfig(name=args.optimizer,
                                  learning_rate=args.lr),
        grad_accum=args.grad_accum,
        compute_dtype="float32" if args.smoke else "bfloat16",
        checkpoint_dir=args.ckpt_dir,
        checkpoint_every=args.ckpt_every,
        log_every=10)
    trainer = Trainer(cfg, tc, rt=ModelRuntime(),
                      batch_size=args.batch, seq_len=args.seq,
                      seed=args.seed, fail_at_step=args.fail_at,
                      device=args.device)

    t0 = time.time()
    tokens_per_step = args.batch * args.seq

    def log(step, m):
        dt = time.time() - t0
        print(f"step {step:5d} loss={m['loss']:.4f} "
              f"ppl={m['perplexity']:.2f} gnorm={m['grad_norm']:.3f} "
              f"({step * tokens_per_step / max(dt, 1e-9):.0f} tok/s)",
              flush=True)

    state = trainer.run(args.steps, on_metrics=log)
    print(f"done at step {int(state['step'])} in {time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
