"""Learning-rate schedules (JAX counterpart ``tcct_tpu/train/schedule.py``).

``cyclic_lr`` is the reference recipe: ``CyclicLR(base_lr=1e-6,
max_lr=1e-4, step_size_up=4, step_size_down=60)`` stepped once per epoch
(task1/kite/loopback.py:128), triangular, a cycle of 64 epochs.
"""

from __future__ import annotations

from typing import Callable


def cyclic_lr(epoch: int, base_lr: float = 1e-6, max_lr: float = 1e-4, step_size_up: int = 4,
              step_size_down: int = 60) -> float:
    """Triangular cyclic learning rate of ``epoch``."""
    pos = epoch % (step_size_up + step_size_down)
    if pos <= step_size_up:
        frac = pos / step_size_up
    else:
        frac = 1.0 - (pos - step_size_up) / step_size_down
    return base_lr + (max_lr - base_lr) * min(max(frac, 0.0), 1.0)


def make_stepwise(schedule_per_epoch: Callable[[int], float],
                  steps_per_epoch: int) -> Callable[[int], float]:
    """A per-epoch schedule as a per-step one."""

    def sched(step: int) -> float:
        return schedule_per_epoch(step // max(steps_per_epoch, 1))

    return sched
