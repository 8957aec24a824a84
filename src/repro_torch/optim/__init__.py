"""AdamW on trees of tensors (the counterpart of ``repro.optim``)."""
from repro_torch.optim.adamw import (OptConfig, global_norm, init,
                                     loss_and_grads, make_train_step,
                                     schedule, update, update_)

__all__ = ["OptConfig", "global_norm", "init", "loss_and_grads",
           "make_train_step", "schedule", "update", "update_"]
