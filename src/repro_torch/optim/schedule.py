"""Learning-rate schedules (host-side callables: step -> lr)."""

from __future__ import annotations

import numpy as np


def constant(lr: float):
    return lambda step: lr


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = min(step / max(total_steps, 1), 1.0)
        return lr * (final_frac + (1 - final_frac) * 0.5 * (1 + np.cos(np.pi * t)))

    return f


def warmup_cosine(lr: float, warmup: int, total_steps: int, final_frac: float = 0.1):
    cos = cosine_decay(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        if step < warmup:
            return lr * (step + 1) / warmup
        return cos(step - warmup)

    return f


class step_decay_on_plateau:
    """Paper §V: 'lr starts at 0.1 and decays by 10x once the loss stops
    decreasing'.  Stateful host-side schedule."""

    def __init__(self, lr: float, factor: float = 0.1, patience: int = 200, tol: float = 1e-3):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.tol = tol
        self.best = np.inf
        self.bad = 0

    def observe(self, loss: float) -> None:
        if loss < self.best - self.tol:
            self.best = loss
            self.bad = 0
        else:
            self.bad += 1
            if self.bad >= self.patience:
                self.lr *= self.factor
                self.bad = 0

    def __call__(self, step: int) -> float:
        return self.lr
