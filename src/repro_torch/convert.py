"""Carry weights from the JAX reference into the port.

``stack_params_from_numpy`` takes the reference's ``LSTMStackParams`` after
``jax.tree.map(np.asarray, params)`` (or any object or mapping with the
same field names) and returns the port's ``LSTMStackParams`` on ``device``.
Layouts are kept as they are: ``w_x`` (4, N_h, N_x), ``w_h`` (4, N_h, N_h),
``w_peep`` (3, N_h), ``b`` (4, N_h), ``w_out`` (N_out, N_h), ``b_out``
(N_out,).  ``quantized_packed_from_numpy`` does the same for one quantized
layer (``QuantizedPackedLSTM``), keeping its integer dtypes.
``train_state_from_numpy`` carries a whole train state — the reference's
``{'params', 'opt', 'step'}`` with AdamW's moments — into the port's.
Nothing here imports JAX; the values are copied bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.lstm import LSTMParams, LSTMStackParams
from .core.systolic import QuantizedPackedLSTM
from .optim import AdamWState


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


# field -> dtype of a quantized layer's codes
_QUANTIZED_FIELDS = (('tiles_q', np.int8), ('peep_q', np.int8),
                     ('bias_q', np.int16), ('sig_lut', np.int8),
                     ('tanh_lut', np.int8))


def quantized_packed_from_numpy(qp, device='cuda') -> QuantizedPackedLSTM:
    """The port's ``QuantizedPackedLSTM`` from a numpy copy of the
    reference's (by attribute or key): ``tiles_q`` int8 (R, C, 4, t, t),
    ``peep_q`` int8 (R, 3, t), ``bias_q`` int16 (R, 4, t), the two int8 LUTs
    (256,) and ``plan_shape``, on ``device``.  Raises ``ValueError`` if a
    field does not have its integer dtype (no silent conversion)."""
    arrays = []
    for name, dtype in _QUANTIZED_FIELDS:
        a = np.asarray(_field(qp, name))
        if a.dtype != dtype:
            raise ValueError(f'{name}: dtype {a.dtype}, expected '
                             f'{np.dtype(dtype)}')
        arrays.append(torch.from_numpy(np.array(a, order='C', copy=True)
                                       ).to(device))
    plan_shape = tuple(int(v) for v in _field(qp, 'plan_shape'))
    return QuantizedPackedLSTM(*arrays, plan_shape=plan_shape)


def _step(a) -> torch.Tensor:
    return torch.tensor(int(np.asarray(a)), dtype=torch.int32)


def train_state_from_numpy(state, device='cuda'):
    """The port's train state ``{'params', 'opt', 'step'}`` from a numpy
    copy of the reference's (``jax.tree.map(np.asarray, state)`` with an
    ``AdamWState(step, m, v)`` optimizer state): parameters and both
    moments on ``device``, the two step counters as 0-d int32 tensors on
    the CPU (where the port keeps its scalars)."""
    opt = _field(state, 'opt')
    return {'params': stack_params_from_numpy(_field(state, 'params'),
                                              device),
            'opt': AdamWState(_step(_field(opt, 'step')),
                              stack_params_from_numpy(_field(opt, 'm'),
                                                      device),
                              stack_params_from_numpy(_field(opt, 'v'),
                                                      device)),
            'step': _step(_field(state, 'step'))}
