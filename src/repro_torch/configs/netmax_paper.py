"""The paper's own experimental configuration (SSV).

NetMax SSV trains ResNet18/VGG19/MobileNet on CIFAR - CNNs on GPU boxes.
The algorithmic reproduction (speedups, ablations, accuracy parity) runs in
the event-driven simulator on small pure-JAX models; this module records the
paper's protocol hyperparameters used by benchmarks/run.py.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class PaperConfig:
    n_workers: int = 8
    batch_size: int = 128
    momentum: float = 0.9
    weight_decay: float = 1e-4
    lr0: float = 0.1
    schedule_period_s: float = 120.0  # T_s = 2 minutes
    ema_beta: float = 0.5
    slow_link_range: tuple = (2.0, 100.0)
    slow_link_interval_s: float = 300.0
    policy_K: int = 10
    policy_R: int = 10
    eps: float = 1e-2


PAPER = PaperConfig()
