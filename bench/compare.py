"""The comparison that decides ``correct``: what the timed path produced for
a sample of its requests, against the configuration's plain reference on
the same frames and the same weights.

Numbers compared (each beside the cell's limit in ``"limits"``): those of
the configuration's reference (``bench/reference/<name>.py``
``readings``: for instance ``logprob_gap``, the largest absolute
difference of a log-prob, and ``code_mismatches``, exact codes that
differ), and ``rows_missing``: sampled requests whose committed outputs do
not number their frames (limit 0).

``control`` gives the same numbers for the configuration's control: the
reference computed in the nearest lower precision, in place of the
program.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

import numpy as np
import torch


def reference(cfg: dict):
    """The configuration's reference module."""
    return importlib.import_module(f'bench.reference.{cfg["reference"]}')


def readings(cfg: dict, weights: dict, sample: List[dict], dev,
             control: bool = False) -> Dict[str, float]:
    """The numbers compared, for the program's outputs in ``sample`` (each
    request's ``frames``, ``length`` and per-frame outputs ``lp`` and what
    else its entry returns), or, with ``control``, for the lower-precision
    reference in their place."""
    frames = [torch.as_tensor(np.ascontiguousarray(s['frames'])).to(dev)
              for s in sample]
    got = reference(cfg).readings(weights, frames,
                                  None if control else sample)
    got['rows_missing'] = sum(1 for s in sample
                              if len(s['lp']) != s['length'])
    return got


def check(cfg: dict, cell: dict, weights: dict, sample: List[dict], dev
          ) -> Dict[str, dict]:
    """Each number compared beside its limit."""
    got = readings(cfg, weights, sample, dev)
    return {k: {'value': v, 'limit': cell['limits'][k]}
            for k, v in got.items()}


def control(cfg: dict, weights: dict, sample: List[dict], dev
            ) -> Dict[str, float]:
    return readings(cfg, weights, sample, dev, control=True)
