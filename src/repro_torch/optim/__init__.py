"""Optimizers and learning-rate schedules of the port (``repro/optim``)."""

from repro_torch.optim.optimizers import Optimizer, adamw, sgd
from repro_torch.optim.schedule import constant, cosine_decay, step_decay_on_plateau, warmup_cosine

__all__ = [
    "Optimizer",
    "adamw",
    "sgd",
    "constant",
    "cosine_decay",
    "step_decay_on_plateau",
    "warmup_cosine",
]
