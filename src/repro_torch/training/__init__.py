"""The port's training: AdamW and Adafactor (`repro_torch.training.
optimizer`) and the train step and checkpointed trainer
(`repro_torch.training.train_loop`), the JAX package's `repro.training`."""
from repro_torch.training.optimizer import (OptimizerConfig, apply_optimizer,
                                            init_optimizer)
from repro_torch.training.train_loop import (TrainConfig, Trainer,
                                             init_state, make_train_step)

__all__ = ["OptimizerConfig", "TrainConfig", "Trainer", "apply_optimizer",
           "init_optimizer", "init_state", "make_train_step"]
