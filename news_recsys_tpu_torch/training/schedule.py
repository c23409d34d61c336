"""Learning-rate schedules. Port of :mod:`news_recsys_tpu.training.schedule`.

``hold_cosine_floor`` reproduces the reference's ``CosinDecayLR``
(``src/model/model_utils/lr_schedule.py:16-28``): constant ``lr`` until
``milestones[0]``, cosine decay from ``lr`` to ``min_lr`` between the two
milestones, constant ``min_lr`` after. The port evaluates it on the host,
as a plain ``step -> float``, and sets the result on the optimizer before
each step.
"""

from __future__ import annotations

import math
from typing import Callable


def hold_cosine_floor(lr: float, min_lr: float, milestones) -> Callable[[int], float]:
    m0, m1 = int(milestones[0]), int(milestones[1])
    total_decay = max(1, m1 - m0)

    def schedule(step: int) -> float:
        if step < m0:
            return lr
        if step >= m1:
            return min_lr
        progress = min(max((step - m0) / total_decay, 0.0), 1.0)
        return min_lr + (lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * progress))

    return schedule
