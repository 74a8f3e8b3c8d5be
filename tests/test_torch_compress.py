"""The port's int8 gradient compression (``repro_torch.optim.compress``)
against the reference's (``repro.optim.compress``).

The int8 codes of the same f32 gradients are equal (``array_equal``) and
the scales equal; error feedback keeps the accumulated compressed sum
within a quantum of the true sum (the reference's property test);
``psum_compressed`` over a 4-rank ``gloo`` group equals the reference's
psum over 4 host devices (``shard_map``), each rank's gradients drawn
from its own numpy seed: rtol 1e-6 on the dequantised sum (both sum the
same int32 codes exactly and scale them by the mean of the same scales).
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _subproc import run_with_devices
from repro.optim import compress as jcompress
from repro_torch.optim import compress

SRC = os.path.join(os.path.dirname(__file__), '..', 'src')


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_codes_equal_reference(seed):
    rng = np.random.RandomState(seed)
    g = (rng.randn(7, 33) * rng.choice([1e-4, 1.0, 30.0])).astype(np.float32)
    g[0, 0] = 0.5 * np.abs(g).max()          # a tie of round-half-to-even
    q, s = compress.compress_tensor(torch.from_numpy(g))
    jq, js = jcompress.compress_tensor(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(
        compress.decompress_tensor(q, s).numpy(),
        np.asarray(jcompress.decompress_tensor(jq, js)))


def test_feedback_reduces_bias():
    rng = np.random.RandomState(3)
    g_true = torch.from_numpy(rng.randn(64).astype(np.float32)) * 0.01
    err = compress.init_error_state({'g': g_true})
    acc_c, acc_t = torch.zeros(64), torch.zeros(64)
    for _ in range(30):
        q, s, err = compress.compress_with_feedback({'g': g_true}, err)
        acc_c += compress.decompress_tensor(q['g'], s['g'])
        acc_t += g_true
    quantum = float(g_true.abs().max()) / 127 * 1.5 + 1e-12
    assert float((acc_c - acc_t).abs().max()) < quantum * 2
    # without feedback the residual grows with the steps
    q, s = compress.compress_tensor(g_true)
    drift = 30 * (compress.decompress_tensor(q, s) - g_true)
    assert float(drift.abs().max()) > float((acc_c - acc_t).abs().max())


_GRADS = """
import json
import numpy as np


def grads(r):
    rng = np.random.RandomState(100 + r)
    return {'a': rng.randn(5, 6).astype(np.float32),
            'b': (rng.randn(9) * 0.01).astype(np.float32)}
"""

_REF = _GRADS + """
import jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.optim.compress import init_error_state, psum_compressed
mesh = Mesh(np.array(jax.devices()[:4]), ('d',))
g = {k: jnp.stack([jnp.asarray(grads(r)[k]) for r in range(4)])
     for k in ('a', 'b')}


def f(g):
    g = jax.tree.map(lambda x: x[0], g)
    red, err = psum_compressed(g, init_error_state(g), 'd')
    return jax.tree.map(lambda x: x[None], (red, err))


red, err = shard_map(f, mesh, in_specs=P('d'), out_specs=P('d'),
                     check_rep=False)(g)
print(json.dumps({'a': np.asarray(red['a'][0]).tolist(),
                  'b': np.asarray(red['b'][0]).tolist(),
                  'err_a': np.asarray(err['a'][1]).tolist()}))
"""

_PORT = _GRADS + """
import socket
import sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from repro_torch.optim.compress import init_error_state, psum_compressed


def run(rank, port, out):
    dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}',
                            rank=rank, world_size=4)
    g = {k: torch.from_numpy(v) for k, v in grads(rank).items()}
    red, err = psum_compressed(g, init_error_state(g))
    if rank == 1:
        with open(out, 'w') as fh:
            json.dump({'a': red['a'].tolist(), 'b': red['b'].tolist(),
                       'err_a': err['a'].tolist()}, fh)
    dist.destroy_process_group()


if __name__ == '__main__':
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    mp.spawn(run, args=(port, sys.argv[1]), nprocs=4)
"""


def test_psum_compressed_over_gloo_equals_reference(tmp_path):
    # the port's 4-rank group runs while the reference's psum does
    script, out = tmp_path / 'psum.py', tmp_path / 'out.json'
    script.write_text(_PORT)
    proc = subprocess.Popen([sys.executable, str(script), str(out)],
                            env=dict(os.environ, PYTHONPATH=SRC), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    ref = json.loads(run_with_devices(_REF, n_devices=4).splitlines()[-1])
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    got = json.loads(out.read_text())
    for k in ('a', 'b', 'err_a'):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=0)
