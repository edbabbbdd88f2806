"""The training loop: a train step with microbatch gradient accumulation
and mixed precision, and a checkpointed trainer with auto-resume and
failure injection.

Counterpart of `repro.training.train_loop`:

- master parameters in ``param_dtype`` (f32); each microbatch's loss
  runs on a ``compute_dtype`` cast of them, so the gradients land on
  the masters;
- ``grad_accum`` slices the batch into that many microbatches and sums
  their gradients in ``grad_dtype`` (the JAX package's ``lax.scan``; a
  Python loop here, one microbatch's activations alive at a time);
- the remat policy and attention route through ``ModelRuntime``;
- each step's batch is drawn from a generator seeded from ``(seed + 7,
  step)`` (`repro_torch.data.TokenStream`), so a restart reproduces the
  run.

Over a mesh the state's leaves are DTensors placed by
`repro_torch.distributed.plan.state_specs` and the batch by
``batch_specs``; the step runs under the caller's ``sharding_rules``.
Each master is cast to ``grad_dtype`` and gathered over the batch's mesh
dims (FSDP's all-gather) before the cast to ``compute_dtype``, so its
gradient is reduce-scattered in ``grad_dtype`` (the JAX package's
compressed reduction where that is bf16); each microbatch is a slice of
every rank's own batch rows.  The optimizer then runs on the shards.

A step updates the state's tensors in place (the JAX package returns new
trees).  Its gradient is the same on every run of the same inputs: the
norm and softmax backwards are plain sums, the embedding's and the
MoE's gathers add without atomics (`repro_torch.models.layers.
gather_rows`), and no process-wide switch is touched.
"""
from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import TokenStream
from repro_torch.distributed.sharding import fsdp_gathered, is_dtensor
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import (DEFAULT_RUNTIME, ModelRuntime,
                                            forward_train, init_params)
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.device import resolve_device
from repro_torch.training.optimizer import (OptimizerConfig, apply_optimizer,
                                            init_optimizer, tree_leaves,
                                            tree_map)


@dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    grad_accum: int = 1
    compute_dtype: str = "bfloat16"
    grad_dtype: str = "float32"      # "bfloat16" = compressed grad reduce
    param_dtype: str = "float32"
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    keep_last: int = 3
    log_every: int = 10


def init_state(cfg: ModelConfig, tc: TrainConfig, seed: int = 0,
               device=None) -> Dict[str, Any]:
    """``{"params", "opt", "step"}``: weights from ``seed`` in
    ``tc.param_dtype``, the optimizer's state and an int32 step, on
    ``device`` (default the card)."""
    dev = resolve_device(device)
    params = init_params(cfg, seed=seed, device=dev,
                         param_dtype=tc.param_dtype)
    opt = init_optimizer(params, tc.optimizer)
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _like(tree: Any, leaves) -> Any:
    """``leaves`` (in :func:`tree_leaves` order) in ``tree``'s shape."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(tree)


def loss_and_grads(cfg: ModelConfig, tc: TrainConfig, rt: ModelRuntime,
                   params: Any, micro: Dict[str, Any]):
    """One microbatch's ``forward_train`` on a ``tc.compute_dtype`` cast
    of the master ``params`` and its gradient with respect to them:
    ``(loss, metrics, grads)``, the gradients in :func:`tree_leaves`
    order and the masters' dtype (zeros for a leaf the loss does not
    reach, as in the JAX package)."""
    compute_dt = torch_dtype(tc.compute_dtype)
    grad_dt = torch_dtype(tc.grad_dtype)
    masters = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        cparams = _like(params, [
            fsdp_gathered(p, grad_dt).to(compute_dt)
            if p.dtype in (torch.float32, torch.bfloat16)
            else p for p in masters])
        loss, metrics = forward_train(cfg, cparams, micro, rt=rt)
        grads = torch.autograd.grad(loss, masters, allow_unused=True,
                                    materialize_grads=True)
    grads = [g.redistribute(p.device_mesh, p.placements)
             if is_dtensor(g) and tuple(g.placements) != tuple(p.placements)
             else g for g, p in zip(grads, masters)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            list(grads))



def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    rt: ModelRuntime = DEFAULT_RUNTIME) -> Callable:
    """Returns step(state, batch) -> (state, metrics): batch dims are
    (grad_accum * micro_batch, ...) and are split for accumulation.  The
    state's tensors are updated in place; metrics are ``loss``,
    ``aux_loss``, ``perplexity`` and ``grad_norm`` (0-d tensors)."""
    grad_dt = torch_dtype(tc.grad_dtype)
    grad_fn = functools.partial(loss_and_grads, cfg, tc, rt)

    def split_micro(batch, i):
        def slice_leaf(x):
            if is_dtensor(x):       # slice i of this rank's own rows
                from torch.distributed.tensor import DTensor
                xl = x.to_local()
                mb = xl.shape[0] // tc.grad_accum
                return DTensor.from_local(xl[i * mb:(i + 1) * mb],
                                          x.device_mesh, x.placements)
            mb = x.shape[0] // tc.grad_accum
            return x[i * mb:(i + 1) * mb]
        return {k: slice_leaf(v) for k, v in batch.items()}

    def step(state, batch):
        params = state["params"]
        if tc.grad_accum == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            gsum, loss_sum = None, None
            for i in range(tc.grad_accum):
                loss, _, g = grad_fn(params, split_micro(batch, i))
                g = [x.to(grad_dt) for x in g]
                if gsum is None:
                    gsum, loss_sum = g, loss.float()
                else:
                    for a, b in zip(gsum, g):
                        a.add_(b)
                    loss_sum = loss_sum + loss
            grads = [g.div_(tc.grad_accum) for g in gsum]
            loss = loss_sum / tc.grad_accum
            metrics = {"loss": loss, "aux_loss": torch.zeros_like(loss),
                       "perplexity": torch.exp(torch.clamp(loss, max=20.0))}
        grads = _like(params, [g.to(grad_dt) for g in grads])
        params, opt, gnorm = apply_optimizer(params, grads, state["opt"],
                                             tc.optimizer)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        return {"params": params, "opt": opt,
                "step": state["step"] + 1}, metrics

    return step


@dataclass
class Trainer:
    """Checkpointed trainer with crash-recovery semantics, on ``device``
    (default the card)."""
    cfg: ModelConfig
    tc: TrainConfig
    rt: ModelRuntime = ModelRuntime()
    batch_size: int = 8
    seq_len: int = 128
    seed: int = 0
    fail_at_step: Optional[int] = None    # failure injection (tests)
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._step_fn = make_train_step(self.cfg, self.tc, self.rt)
        self._stream = TokenStream(self.cfg, self.batch_size, self.seq_len,
                                   self.seed + 7, device=self.device)

    def data_for_step(self, step: int) -> Dict[str, Any]:
        # deterministic per-step seed -> restart-reproducible trajectory
        return self._stream.batch(step)

    def restore_or_init(self) -> Dict[str, Any]:
        state = init_state(self.cfg, self.tc, self.seed, self.device)
        if self.tc.checkpoint_dir:
            latest = ckpt.load_latest(self.tc.checkpoint_dir)
            if latest is not None:
                _, tree, _ = latest
                with torch.no_grad():
                    tree_map(lambda ref, loaded: ref.copy_(loaded), state,
                             tree)
        return state

    def run(self, num_steps: int,
            on_metrics: Optional[Callable[[int, Dict], None]] = None
            ) -> Dict[str, Any]:
        state = self.restore_or_init()
        start = int(state["step"])
        pending_save: Optional[threading.Thread] = None
        for step in range(start, num_steps):
            if self.fail_at_step is not None and step == self.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            batch = self.data_for_step(step)
            state, metrics = self._step_fn(state, batch)
            if on_metrics and (step + 1) % self.tc.log_every == 0:
                on_metrics(step + 1,
                           {k: float(v) for k, v in metrics.items()})
            if self.tc.checkpoint_dir and \
                    (step + 1) % self.tc.checkpoint_every == 0:
                if pending_save is not None:
                    pending_save.join()
                pending_save = ckpt.save_async(
                    self.tc.checkpoint_dir, step + 1, state,
                    metadata={"arch": self.cfg.name},
                    keep_last=self.tc.keep_last)
        if pending_save is not None:
            pending_save.join()
        if self.tc.checkpoint_dir and int(state["step"]) not in \
                ckpt.available_steps(self.tc.checkpoint_dir):
            ckpt.save(self.tc.checkpoint_dir, int(state["step"]), state,
                      metadata={"arch": self.cfg.name},
                      keep_last=self.tc.keep_last)
        return state
