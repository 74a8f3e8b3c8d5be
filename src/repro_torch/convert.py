"""Carry weights from the JAX reference into the port.

``stack_params_from_numpy`` takes the reference's ``LSTMStackParams`` after
``jax.tree.map(np.asarray, params)`` (or any object or mapping with the
same field names) and returns the port's ``LSTMStackParams`` on ``device``.
Layouts are kept as they are: ``w_x`` (4, N_h, N_x), ``w_h`` (4, N_h, N_h),
``w_peep`` (3, N_h), ``b`` (4, N_h), ``w_out`` (N_out, N_h), ``b_out``
(N_out,).  Nothing here imports JAX; the values are copied bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.lstm import LSTMParams, LSTMStackParams


def _field(obj, name):
    """``obj.name`` or ``obj[name]``."""
    if isinstance(obj, dict):
        return obj[name]
    return getattr(obj, name)


def _tensor(a, device):
    return None if a is None else torch.from_numpy(
        np.array(a, np.float32, order='C', copy=True)).to(device)


def stack_params_from_numpy(tree, device='cuda') -> LSTMStackParams:
    """The port's stack parameters from a numpy copy of the reference's
    (by attribute or key; layers in order), on ``device``."""
    layers = tuple(
        LSTMParams(*(_tensor(_field(l, n), device)
                     for n in ('w_x', 'w_h', 'w_peep', 'b')))
        for l in _field(tree, 'layers'))
    return LSTMStackParams(layers, _tensor(_field(tree, 'w_out'), device),
                           _tensor(_field(tree, 'b_out'), device))
