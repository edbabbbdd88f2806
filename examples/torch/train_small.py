"""Training example with fault tolerance, on the PyTorch port: trains a
reduced-config model for a few hundred steps with periodic async
checkpoints, then simulates a node failure and auto-resumes — the
restart reproduces the uninterrupted trajectory bit-for-bit
(deterministic per-step data seeds, a gradient without atomics).

    PYTHONPATH=src python examples/torch/train_small.py [--arch zamba2-1.2b]
    PYTHONPATH=src python examples/torch/train_small.py --device cpu

The reduced config (the default) trains on the card too: its train path
runs only the norm and softmax kernels, at any width they are built for,
and each checkpoint is a few megabytes.
"""
import argparse
import shutil
import tempfile
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.training import OptimizerConfig, TrainConfig, Trainer
from repro_torch.training.optimizer import tree_leaves


def main(argv=None) -> bool:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced config (default; --no-smoke for full)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    workdir = tempfile.mkdtemp(prefix="turbo_train_")
    tc = TrainConfig(
        optimizer=OptimizerConfig(name="adamw", learning_rate=1e-3),
        compute_dtype="float32", grad_accum=2,
        checkpoint_dir=workdir, checkpoint_every=50, log_every=20)

    def log(step, m):
        print(f"  step {step:4d}  loss={m['loss']:.4f} "
              f"ppl={m['perplexity']:.1f} gnorm={m['grad_norm']:.2f}",
              flush=True)

    print(f"training reduced {args.arch} "
          f"({cfg.num_layers}L d={cfg.d_model}) for {args.steps} steps")
    t0 = time.time()
    try:
        trainer = Trainer(cfg, tc, batch_size=args.batch, seq_len=args.seq,
                          seed=0, fail_at_step=args.steps // 2,
                          device=args.device)
        try:
            trainer.run(args.steps, on_metrics=log)
        except RuntimeError as e:
            print(f"!! {e} — simulating node failure; restarting from the "
                  f"latest checkpoint ...")

        resumed = Trainer(cfg, tc, batch_size=args.batch, seq_len=args.seq,
                          seed=0, device=args.device)
        state = resumed.run(args.steps, on_metrics=log)
        print(f"finished at step {int(state['step'])} "
              f"in {time.time()-t0:.1f}s (incl. crash+resume)")

        # verify determinism vs an uninterrupted run
        probe = Trainer(cfg, TrainConfig(
            optimizer=tc.optimizer, compute_dtype="float32",
            grad_accum=2), batch_size=args.batch, seq_len=args.seq, seed=0,
            device=args.device)
        ref = probe.run(args.steps)
        same = all(torch.equal(a, b)
                   for a, b in zip(tree_leaves(ref["params"]),
                                   tree_leaves(state["params"])))
        print("crash/resume trajectory bitwise identical:", same)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return same


if __name__ == "__main__":
    main()
