"""Training loop building blocks."""

from repro_torch.train.steps import (loss_and_grads, make_eval_step,
                                     make_train_step)

__all__ = ["make_train_step", "make_eval_step", "loss_and_grads"]
