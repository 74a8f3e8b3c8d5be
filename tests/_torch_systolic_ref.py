"""Shared harness of the port's scale-out parity tests
(``tests/test_torch_systolic.py``, ``tests/test_torch_staged.py``).

The reference's scale-outs need several JAX devices, which a process gets
only at start (``XLA_FLAGS=--xla_force_host_platform_device_count``), so
each test file computes every multi-device reference case in ONE
subprocess (``run_reference``): the inputs — numpy weights and frames drawn
from a seed — go in through an ``.npz``, the snippet builds the reference's
parameters and meshes from them and fills ``OUT``, and the arrays come
back through another ``.npz``.  The port gets the same weights through
``repro_torch.convert``.
"""
from __future__ import annotations

import pathlib
from typing import Dict

import numpy as np

from _subproc import run_with_devices
from repro_torch.convert import stack_params_from_numpy

FIELDS = ('w_x', 'w_h', 'w_peep', 'b')

_PRELUDE = '''
import numpy as np, jax, jax.numpy as jnp
from repro.core import lstm, quant, systolic
IN = dict(np.load({inp!r}))
OUT = {{}}

def layer(name):
    return lstm.LSTMParams(*(jnp.asarray(IN[name + '.' + f])
                             for f in {fields!r}))

def stack(name, n):
    return lstm.LSTMStackParams(
        tuple(layer(name + '.' + str(l)) for l in range(n)), None, None)

def qstack(name, n, tile):
    out = []
    for l in range(n):
        p = layer(name + '.' + str(l))
        plan = systolic.SystolicPlan(p.n_x, p.n_h, tile)
        out.append(systolic.quantize_packed(systolic.pack_lstm(p, plan)))
    return out

def mesh(rows, cols, stage=1):
    return systolic.make_systolic_mesh(rows, cols, stage=stage)
'''

_EPILOGUE = '''
np.savez({out!r}, **{{k: np.asarray(v) for k, v in OUT.items()}})
print('OK')
'''


def layer_weights(rng: np.random.RandomState, n_x: int, n_h: int
                  ) -> Dict[str, np.ndarray]:
    """One layer's weights drawn like the reference's init (uniform in
    [-1, 1) over sqrt(fan-in), peepholes x 0.1, small biases)."""
    def u(*shape):
        return rng.uniform(-1, 1, shape).astype(np.float32)
    return dict(w_x=u(4, n_h, n_x) / np.float32(np.sqrt(n_x)),
                w_h=u(4, n_h, n_h) / np.float32(np.sqrt(n_h)),
                w_peep=u(3, n_h) * np.float32(0.1),
                b=u(4, n_h) * np.float32(0.1))


def put_stack(inputs: dict, name: str, rng, n_x: int, n_h: int,
              n_layers: int) -> None:
    """Draw an ``n_layers`` stack (``n_x -> n_h -> ... -> n_h``) into
    ``inputs`` under ``name.<layer>.<field>``."""
    for l in range(n_layers):
        w = layer_weights(rng, n_x if l == 0 else n_h, n_h)
        for f in FIELDS:
            inputs[f'{name}.{l}.{f}'] = w[f]


def stack_tree(inputs: dict, name: str, n_layers: int) -> dict:
    """The stack ``name`` as the mapping ``convert`` and the reference's
    ``LSTMStackParams`` fields name (no read-out)."""
    return {'layers': [{f: inputs[f'{name}.{l}.{f}'] for f in FIELDS}
                       for l in range(n_layers)],
            'w_out': None, 'b_out': None}


def port_stack(inputs: dict, name: str, n_layers: int):
    """The port's ``LSTMStackParams`` of stack ``name`` on the CPU, carried
    by ``repro_torch.convert``."""
    return stack_params_from_numpy(stack_tree(inputs, name, n_layers), 'cpu')


def jax_stack(inputs: dict, name: str, n_layers: int):
    """The reference's ``LSTMStackParams`` of stack ``name``, in process."""
    import jax.numpy as jnp
    from repro.core import lstm as jlstm
    return jlstm.LSTMStackParams(tuple(
        jlstm.LSTMParams(*(jnp.asarray(inputs[f'{name}.{l}.{f}'])
                           for f in FIELDS)) for l in range(n_layers)),
        None, None)


def run_reference(body: str, inputs: dict, tmp_dir: pathlib.Path,
                  n_devices: int) -> Dict[str, np.ndarray]:
    """Run ``body`` in one JAX subprocess with ``n_devices`` host devices.
    ``body`` sees ``IN`` (the inputs), ``layer``/``stack``/``qstack``
    (reference parameters of a stored stack, ``name.<l>`` per layer) and
    ``mesh(rows, cols, stage)``, and fills ``OUT``; returns ``OUT``."""
    tmp_dir = pathlib.Path(tmp_dir)
    inp, out = tmp_dir / 'reference_in.npz', tmp_dir / 'reference_out.npz'
    np.savez(inp, **inputs)
    code = (_PRELUDE.format(inp=str(inp), fields=FIELDS) + body
            + _EPILOGUE.format(out=str(out)))
    assert 'OK' in run_with_devices(code, n_devices=n_devices)
    with np.load(out) as f:
        return {k: f[k] for k in f.files}
