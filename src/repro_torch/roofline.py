"""Roofline terms of a traced step, per rank, on the card's rates.

Counterpart of ``repro.roofline``.  Three terms per (arch x shape x mesh),
all in seconds a step on one rank:

  compute    = sum over dtypes of that dtype's FLOPs / the card's peak for it
  memory     = HBM bytes / HBM bandwidth
  collective = collective operand bytes / NVLink bandwidth (one direction)

The inputs come from ``op_cost``'s ``CostRecord`` of the step traced on the
rank's local shards (``launch.dryrun``).  The rates are one H100's
(``launch.mesh``).  Deviation from the reference, whose compute term divides
every FLOP by the bf16 peak: here each dtype's FLOPs go at their own peak,
since the card runs f32 without TF32 at 67 TFLOP/s against bf16's 989.
Ring factors (~2x for an all-reduce) are not modelled: the terms are lower
bounds, consistent across configurations.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .launch.mesh import HBM_BW, LINK_BW, peak_rate


def dtype_peak(name: str) -> float:
    """The card's peak rate for operands of dtype ``name`` ('bfloat16',
    'float32', 'int8', ...)."""
    return peak_rate(getattr(torch, name, torch.float32))


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # per-chip FLOPs
    hbm_bytes: float             # per-chip HBM bytes accessed
    collective_bytes: float      # per-chip collective operand bytes
    per_collective: Dict[str, int]
    model_flops: Optional[float] = None   # 6*N*D (dense) / 6*N_active*D (MoE)
    flops_by_dtype: Optional[Dict[str, float]] = None

    @property
    def compute_s(self) -> float:
        by = self.flops_by_dtype or {'bfloat16': self.flops}
        return sum(f / dtype_peak(d) for d, f in by.items())

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {'compute': self.compute_s, 'memory': self.memory_s,
                 'collective': self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound_s(self) -> float:
        # perfect overlap: the largest term (no overlap would be the sum)
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> Optional[float]:
        """MODEL_FLOPS / counted FLOPs: catches remat and redundancy."""
        if not self.model_flops or not self.flops:
            return None
        return self.model_flops / self.flops

    @property
    def roofline_fraction(self) -> Optional[float]:
        """MFU-like score: the model FLOPs' time at the peak of the dtype
        that carries most of the counted FLOPs, over the lower bound."""
        if not self.model_flops or not self.step_time_lower_bound_s:
            return None
        by = self.flops_by_dtype or {'bfloat16': self.flops}
        main = max(by, key=by.get) if by else 'bfloat16'
        return (self.model_flops / dtype_peak(main)
                / self.step_time_lower_bound_s)

    def to_dict(self) -> Dict:
        return {
            'flops': self.flops, 'hbm_bytes': self.hbm_bytes,
            'collective_bytes': self.collective_bytes,
            'per_collective': self.per_collective,
            'model_flops': self.model_flops,
            'compute_s': self.compute_s, 'memory_s': self.memory_s,
            'collective_s': self.collective_s, 'bottleneck': self.bottleneck,
            'useful_flops_fraction': self.useful_flops_fraction,
            'roofline_fraction': self.roofline_fraction,
        }


def analyze(cost, model_flops_per_chip: Optional[float] = None
            ) -> RooflineTerms:
    """The terms of an ``op_cost.CostRecord`` (one rank's traced step)."""
    per = {k: int(v) for k, v in cost.coll.items()}
    return RooflineTerms(
        flops=float(cost.flops), hbm_bytes=float(cost.bytes),
        collective_bytes=float(sum(per.values())), per_collective=per,
        model_flops=model_flops_per_chip,
        flops_by_dtype=dict(cost.flops_by_dtype))
