"""A sharded train step of the port on a 2-rank ``gloo`` group, against
the same step unsharded.

Each rank runs the donating train step (``launch.train.make_train_step``)
on a state placed by its logical axes under ``TRAIN_RULES``
(``launch.train.state_layouts`` / ``place_state``) and a batch from
``data.ShardedLoader``, on two meshes: (data, model) = (2, 1) (data
parallel, the weights FSDP-split on their embed dim) and (1, 2) (tensor
parallel).  Checked, for the CTC LSTM's smoke config, a dense LM's (Qwen3
smoke) and an MoE LM's (Mixtral smoke: each rank dispatches its own
token groups, the experts split over the data axis), f32 activations and
SGD (an update is the gradient times the learning rate):

  * each rank's batch rows are its slice of the global batch;
  * the loss and the gradient norm equal the unsharded step's under the
    same rules (rtol 1e-5),
    and each parameter's update is within 1e-3 of its largest element
    (f32: partial sums meet in another order);
  * a checkpoint saved on the (2, 1) mesh restores onto the (1, 2) mesh,
    each leaf equal;
  * the training CLI (``launch.train.main``) run on both ranks places its
    state on ``local_mesh()`` ((1, 2) on two ranks) and steps under
    ``TRAIN_RULES``: the CTC LSTM's losses and gradient norms, as it
    prints them (4 and 3 decimals), equal those of the same CLI run alone
    (in one process, no group) at step 0 and, after one AdamW update
    (which can flip the sign of a near-zero gradient's step), within
    2e-4 at step 1.
"""
import json
import os
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(__file__), '..', 'src')

_WORKER = '''
import json
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def cli(ckdir):
    import contextlib
    import io
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(['--arch', 'chipmunk-ctc', '--smoke', '--steps', '2',
                    '--batch', '4', '--seq', '16', '--log-every', '1',
                    '--device', 'cpu', '--ckpt-dir', ckdir])
    return buf.getvalue()


def run(rank, port, out, ckdir):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import configs, sharding as shd
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import ShardedLoader, source_for
    from repro_torch.launch.mesh import resolve_rules
    from repro_torch.launch.train import (batch_shardings, init_train_state,
                                          loss_fn_for, make_train_step,
                                          place_state, state_layouts)
    from repro_torch.optim import cosine_schedule, make_optimizer
    from repro_torch.tree import leaves, tree_map

    res = {}
    if rank == 0:
        res['cli_alone'] = cli(ckdir + '/alone')
    dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}',
                            rank=rank, world_size=2)
    res['cli_ranks'] = cli(ckdir + '/ranks')
    full = lambda t: t.full_tensor() if shd.is_dtensor(t) else t
    for arch in ('chipmunk-ctc', 'qwen3-14b', 'mixtral-8x22b'):
        cfg = configs.get_smoke_config(arch).replace(
            optimizer='sgd', activation_dtype='float32')
        shape = configs.ShapeConfig('t', 'train', 16, 4)
        opt = make_optimizer(cfg.optimizer, cosine_schedule(1e-2, 1, 10))
        step = make_train_step(loss_fn_for(cfg), opt, donate=True)
        state = init_train_state(cfg, opt, 'cpu', seed=0)
        src = source_for(cfg, shape)
        host = src.host_batch(0, 0, shape.global_batch)
        old = leaves(state['params'])
        plain = None
        for dims in ((2, 1), (1, 2)):
            mesh = init_device_mesh('cpu', dims,
                                    mesh_dim_names=('data', 'model'))
            rules = shd.ShardingRules(mesh, resolve_rules(shd.TRAIN_RULES,
                                                          mesh))
            # the unsharded step under the same rules (an MoE block takes
            # a token group per data-parallel shard, as the reference's;
            # nothing else reads them)
            if plain is None or cfg.moe is not None:
                with shd.use_rules(rules):
                    plain, pm = step(tree_map(lambda t: t.clone(), state),
                                     {k: torch.from_numpy(v)
                                      for k, v in host.items()})
                want = [w - o for w, o in zip(leaves(plain['params']), old)]
            lay = state_layouts(state, mesh, cfg, shd.TRAIN_RULES)
            placed = place_state(tree_map(lambda t: t.clone(), state), lay)
            loader = ShardedLoader(src, shape, batch_shardings(
                cfg, shape, mesh, shd.TRAIN_RULES))
            _, batch = next(loader)
            loader.close()
            per = shape.global_batch // dims[0]
            rows = all(torch.equal(
                batch[k].to_local(),
                torch.from_numpy(host[k])[rank * per:(rank + 1) * per]
                if dims[0] == 2 else torch.from_numpy(host[k]))
                for k in batch)
            with shd.use_rules(rules), implicit_replication():
                new, m = step(placed, batch)
            got = [full(t) - o for t, o in zip(leaves(new['params']), old)]
            res[f'{arch} {dims}'] = dict(
                rows=rows,
                update_err=max(float((g - w).abs().max() / w.abs().max())
                               for g, w in zip(got, want)),
                loss=[float(full(m['loss'])), float(pm['loss'])],
                grad_norm=[float(full(m['grad_norm'])),
                           float(pm['grad_norm'])],
                sharded=sum(not all(p.is_replicate() for p in t.placements)
                            for t in leaves(new['params'])
                            if shd.is_dtensor(t)))
            if arch == 'qwen3-14b' and dims == (2, 1):
                ck = CheckpointManager(ckdir)
                ck.save(1, new, blocking=True)
                dist.barrier()
                other = init_device_mesh('cpu', (1, 2),
                                         mesh_dim_names=('data', 'model'))
                back = ck.restore(new, shardings=state_layouts(
                    state, other, cfg, shd.TRAIN_RULES))
                res['restore'] = dict(
                    equal=all(torch.equal(full(a), full(b)) for a, b in zip(
                        leaves(back), leaves(new))),
                    meshes=[tuple(leaves(back['params'])[0].device_mesh.shape),
                            tuple(leaves(new['params'])[0].device_mesh.shape)])
    if rank == 0:
        with open(out, 'w') as fh:
            json.dump(res, fh)
    dist.destroy_process_group()


if __name__ == '__main__':
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    mp.spawn(run, args=(port, sys.argv[1], sys.argv[2]), nprocs=2)
'''


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp('sharded_step')
    script, out = d / 'worker.py', d / 'out.json'
    script.write_text(_WORKER)
    proc = subprocess.run([sys.executable, str(script), str(out),
                           str(d / 'ckpt')],
                          env=dict(os.environ, PYTHONPATH=SRC), text=True,
                          capture_output=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize('case', [
    f'{a} {m}' for a in ('chipmunk-ctc', 'qwen3-14b', 'mixtral-8x22b')
    for m in ('(2, 1)', '(1, 2)')])
def test_sharded_step_equals_unsharded(results, case):
    r = results[case]
    assert r['rows'], 'a rank holds other rows than its slice'
    assert r['loss'][0] == pytest.approx(r['loss'][1], rel=1e-5)
    assert r['grad_norm'][0] == pytest.approx(r['grad_norm'][1], rel=1e-5)
    assert r['update_err'] <= 1e-3
    assert r['sharded'] > 0


def _cli_steps(log: str):
    """{step: (loss, grad norm)} of the training CLI's log lines."""
    out = {}
    for line in log.splitlines():
        w = line.split()
        if w and w[0] == 'step':
            out[int(w[1])] = (float(w[3]), float(w[5]))
    return out


def test_train_cli_on_two_ranks_equals_one_process(results):
    alone, ranks = results['cli_alone'], results['cli_ranks']
    assert "mesh {'data': 1, 'model': 2} of 2 ranks" in ranks
    assert 'mesh' not in alone
    a, r = _cli_steps(alone), _cli_steps(ranks)
    assert sorted(a) == sorted(r) == [0, 1]
    assert a[0] == r[0]
    assert r[1][0] == pytest.approx(a[1][0], abs=2e-4)
    assert r[1][1] == pytest.approx(a[1][1], abs=2e-3)


def test_checkpoint_restores_onto_another_mesh(results):
    r = results['restore']
    assert r['equal']
    assert r['meshes'] == [[1, 2], [2, 1]]
