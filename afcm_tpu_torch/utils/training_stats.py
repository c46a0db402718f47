"""Cross-rank scalar statistics (``afcm_tpu/utils/training_stats.py``;
reference: torch_utils/training_stats.py).

The reference accumulates [num, sum, sum-of-squares] moments per scalar and
sums them across processes with ``all_reduce`` (training_stats.py:55-99,
234-256). ``report_moments`` computes the triple of a tensor on its device;
given a ``parallel.DataGroup`` it sums the triples of the ranks' slices
through the group's counted all-reduce, which gives the global batch's
moments, as the JAX function gives them of a sharded array. The host-side
``Collector``, which aggregates the triples over a reporting window, is a
copy.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

from .. import parallel


def report_moments(value, group: Optional[parallel.DataGroup] = None) -> torch.Tensor:
    """[num, sum, sum_sq] of ``value`` in float32, on its device; summed over
    the ranks of ``group`` when one is given."""
    value = torch.as_tensor(value, dtype=torch.float32)
    triple = torch.stack([torch.tensor(float(value.numel()), device=value.device),
                          value.sum(), value.square().sum()])
    return triple if group is None else group.sum(triple)


class Collector:
    """Aggregate per-step moment triples host-side and report mean/std."""

    def __init__(self, regex: str = ".*"):
        self._regex = re.compile(regex)
        self._moments: Dict[str, np.ndarray] = {}

    def update(self, stats: Dict[str, np.ndarray]):
        for name, triple in stats.items():
            if not self._regex.fullmatch(name):
                continue
            if isinstance(triple, torch.Tensor):
                triple = triple.detach().cpu().numpy()
            triple = np.asarray(triple, np.float64)
            if triple.shape != (3,):  # accept raw scalars too
                value = float(np.mean(triple))
                triple = np.array([1.0, value, value * value])
            if name in self._moments:
                self._moments[name] = self._moments[name] + triple
            else:
                self._moments[name] = triple

    def names(self):
        return list(self._moments)

    def num(self, name: str) -> float:
        return float(self._moments.get(name, np.zeros(3))[0])

    def mean(self, name: str) -> float:
        n, s, _ = self._moments.get(name, np.zeros(3))
        return float(s / n) if n > 0 else float("nan")

    def std(self, name: str) -> float:
        n, s, ss = self._moments.get(name, np.zeros(3))
        if n <= 1:
            return 0.0
        mean = s / n
        var = max(ss / n - mean * mean, 0.0)
        return float(np.sqrt(var))

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {name: {"num": self.num(name), "mean": self.mean(name),
                       "std": self.std(name)} for name in self._moments}

    def reset(self):
        self._moments.clear()
