"""Learning-rate schedules: a copy of ``afcm_tpu/models/schedulers.py``.

The JAX module itself imports nothing heavy, but it is reached through
``afcm_tpu/models/__init__.py``, which imports flax; so the port keeps this
copy, and ``tests/test_torch_train.py`` holds the two equal over all four
policies. The train loop applies the factor through
``train_state.with_lr`` once per epoch.

Policies (reference semantics):

- ``linear``  — flat for ``n_epochs``, then linear to zero over
  ``n_epochs_decay`` epochs (``LambdaLR``, models/utils.py:56-60).
- ``step``    — ×0.1 every ``lr_decay_iters`` epochs (``StepLR``,
  models/utils.py:62).
- ``plateau`` — ``ReduceLROnPlateau(mode='min', factor=0.2, threshold=0.01,
  patience=5)`` (models/utils.py:64).  The reference quirk: its train loop
  never assigns ``model.metric``, so plateau effectively watches a constant —
  here the caller passes the val metric (negated SSIM, so lower = better),
  fixing the broken-in-reference wiring, as the JAX package does.
- ``cosine``  — ``CosineAnnealingLR(T_max=n_epochs, eta_min=0)``
  (models/utils.py:66).
"""

from __future__ import annotations

import math
from typing import Optional


class LRScheduler:
    """Per-epoch multiplicative LR factor, stateful only for ``plateau``.

    ``epoch`` is the train loop's epoch variable, starting at
    ``cfg.scheduler.epoch_count``. The reference steps its torch scheduler
    at the *beginning* of every loop epoch (reference: train.py:44,
    base_model.py:116-123), so while training loop epoch E the scheduler's
    internal counter reads ``E - epoch_count + 1`` — factors below are
    functions of that count, matching the reference timeline exactly
    (e.g. linear with epoch_count=1, n_epochs=n_epochs_decay=10: loop
    epoch 10 trains at 1 - 1/11, and the final loop epoch 20 at 0.0).
    """

    def __init__(self, cfg):
        s = cfg.scheduler
        self.policy = s.lr_policy
        self.epoch_count = getattr(s, "epoch_count", 1)
        self.n_epochs = s.n_epochs
        self.n_epochs_decay = s.n_epochs_decay
        self.lr_decay_iters = s.lr_decay_iters
        if self.policy not in ("linear", "step", "plateau", "cosine"):
            raise NotImplementedError(
                f"learning rate policy [{self.policy}] is not implemented")
        # plateau state (torch ReduceLROnPlateau, mode='min', rel threshold)
        self._factor = 1.0
        self._best: Optional[float] = None
        self._num_bad = 0

    def factor(self, epoch: int, metric: Optional[float] = None) -> float:
        """LR multiplier for this epoch; ``metric`` feeds ``plateau`` only
        (lower is better, e.g. ``-ssim``)."""
        # torch scheduler's internal epoch while loop epoch `epoch` trains
        # (constructed at 0 in setup, stepped once at every epoch start)
        t = epoch - self.epoch_count + 1
        if self.policy == "linear":
            # reference lambda_rule(t) = 1 - max(0, t + epoch_count -
            # n_epochs)/(n_epochs_decay+1) — epoch_count cancels against
            # the internal counter's offset (models/utils.py:57-59)
            return 1.0 - max(0, epoch + 1 - self.n_epochs) / \
                float(self.n_epochs_decay + 1)
        if self.policy == "step":
            return 0.1 ** (t // self.lr_decay_iters)
        if self.policy == "cosine":
            return (1 + math.cos(math.pi * t / self.n_epochs)) / 2.0
        # plateau
        if metric is not None:
            if self._best is None or _is_better(metric, self._best):
                self._best = metric
                self._num_bad = 0
            else:
                self._num_bad += 1
                if self._num_bad > 5:          # patience
                    self._factor *= 0.2        # factor
                    self._num_bad = 0
        return self._factor


def _is_better(a: float, best: float) -> bool:
    """torch ReduceLROnPlateau mode='min', threshold_mode='rel',
    threshold=0.01: improvement means a < best * (1 - 0.01) — exact torch
    semantics, including its (odd) behavior when best < 0."""
    return a < best * (1 - 0.01)
