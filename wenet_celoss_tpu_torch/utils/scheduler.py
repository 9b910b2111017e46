"""Learning-rate schedule (port of ``wenet_celoss_tpu/utils/scheduler.py``)."""

from __future__ import annotations


def warmup_lr(peak_lr: float, warmup_steps: int = 25000):
    """Noam-style warmup then inverse-sqrt decay, a function of the count
    of applied updates: ``peak * w^0.5 * min(s^-0.5, s * w^-1.5)`` with
    ``s = max(step, 1)``, so updates 0 and 1 both take ``lr(1)``."""
    w = float(warmup_steps)

    def schedule(step: int) -> float:
        s = max(float(step), 1.0)
        return peak_lr * w ** 0.5 * min(s ** -0.5, s * w ** -1.5)

    return schedule
