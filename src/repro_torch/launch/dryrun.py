"""The production-mesh dry run: every (architecture x input shape) cell's
real step, traced at full width on one rank of a 256- or 512-rank mesh.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and compiles
each step for 256/512 placeholder devices and reads XLA's memory and cost
analyses.  Here the step runs for real, on DTensors over PyTorch's fake
process group (``launch.mesh.make_production_mesh``) and under
``FakeTensorMode``, so nothing is allocated or computed: the parameters
and the optimizer state are fake DTensors placed by their logical axes
(``launch.train.abstract_train_state``), the batch by ``batch_axes``, the
activations by the models' ``logical`` sites, and ``op_cost.CostMode``
records what rank 0 holds, computes and sends.  Every hand-written kernel
on the path runs on each rank's local shards (``sharding.run_local``) as
its custom op, which the cost model charges by its launch geometry
(``op_cost.KERNEL_COSTS``).

Each cell writes ``results/dryrun_torch/<arch>__<shape>__<sp|mp>.json``
with the reference's keys: status, n_chips, params, active_params, memory
(per-rank ``argument_size_bytes``, ``output_size_bytes`` and
``temp_size_bytes``, the peak of live fake storage over the step) and
roofline (``roofline.analyze`` at one H100's rates)::

    python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k [--multi-pod]
    python -m repro_torch.launch.dryrun --all [--shape train_4k] [--multi-pod] [--jobs 8]
    python -m repro_torch.launch.dryrun --systolic

A process holds one process group, so each invocation (and each test
that makes a group) runs in a process of its own; ``--all`` runs its
cells in one process on one mesh.  Train cells run the donating train
step (``launch.train.make_train_step``) with the reference's
microbatches; prefill cells the forward; decode cells one
``decode_step`` against a full cache (pos = seq_len - 1).  The step runs
on the card's dispatch: the CTC LSTM on K2 (``cuda_seq_fused``), attention
on K8, an MoE block's experts at capacity (no host read of the counts).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

import torch

from .. import op_cost
from .. import sharding as shd
from ..configs import ARCH_MODULES, SHAPES, get_config, shapes_for
from ..models import get_bundle, input_specs
from ..roofline import analyze
from ..tree import leaves, tree_map
from .mesh import make_production_mesh, resolve_rules
from .train import (abstract_init, abstract_train_state, batch_shardings,
                    make_train_step)

RESULTS = (pathlib.Path(__file__).resolve().parents[3] / 'results'
           / 'dryrun_torch')

# Archs whose weights cannot fit TP-only at serve time.
BIG_SERVE = {'kimi-k2-1t-a32b', 'llama-3.2-vision-90b', 'mixtral-8x22b'}

# Gradient-accumulation microbatches per (arch, train) — memory fit lever.
TRAIN_MICROBATCHES = {
    'kimi-k2-1t-a32b': 8, 'mixtral-8x22b': 8, 'llama-3.2-vision-90b': 8,
    'qwen3-14b': 4, 'qwen2.5-14b': 4, 'codeqwen1.5-7b': 4, 'minicpm-2b': 4,
    'hymba-1.5b': 8, 'xlstm-1.3b': 1, 'whisper-base': 1, 'chipmunk-ctc': 1,
}


def serve_rules_for(arch: str):
    return shd.SERVE_BIG_RULES if arch in BIG_SERVE else shd.SERVE_RULES


def model_flops_per_chip(bundle, params, shape, n_chips: int) -> float:
    """MODEL_FLOPS = 6·N(_active)·D train / 2·N·D inference, per chip."""
    n_active = bundle.active_param_count(params)
    if shape.kind == 'train':
        return 6.0 * n_active * shape.global_batch * shape.seq_len / n_chips
    if shape.kind == 'prefill':
        return 2.0 * n_active * shape.global_batch * shape.seq_len / n_chips
    return 2.0 * n_active * shape.global_batch / n_chips


def _local_bytes(tree) -> int:
    """Bytes rank 0 holds of a tree's tensors (a DTensor's local shard)."""
    from torch.distributed.tensor import DTensor
    n = 0
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            n += t.numel() * t.element_size()
    return n


def _fake_inputs(cfg, shape, mesh, rules_dict):
    """The step's batch as fake tensors placed by ``batch_shardings``."""
    lay = batch_shardings(cfg, shape, mesh, rules_dict)
    out = {}
    for k, spec in input_specs(cfg, shape).items():
        t = torch.zeros(spec.shape, dtype=spec.dtype)
        out[k] = lay[k].distribute(t)
    return out


def card_config(cfg):
    """``cfg`` on the card's dispatch: the CTC LSTM's stack on K2."""
    if cfg.family == 'lstm':
        return cfg.replace(lstm_backend='cuda_seq_fused')
    return cfg


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               override_rules=None):
    """Trace one cell's step on rank 0 of the production mesh; returns
    the result record."""
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = card_config(get_config(arch))
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size()
    bundle = get_bundle(cfg)
    base = shd.TRAIN_RULES if shape.kind == 'train' else serve_rules_for(arch)
    rules_dict = override_rules or shd.rules_for_arch(
        base, cfg.n_kv_heads, 16, cfg.family)
    rules = shd.ShardingRules(mesh, resolve_rules(rules_dict, mesh))
    t0 = time.time()
    with op_cost.traced() as mode, implicit_replication(), \
            shd.use_rules(rules):
        with mode.hidden():
            plain, _ = abstract_init(bundle)
            mflops = model_flops_per_chip(bundle, plain, shape, n_chips)
            n_params = bundle.param_count(plain)
            n_active = bundle.active_param_count(plain)
            del plain
            batch = _fake_inputs(cfg, shape, mesh, rules_dict)
            if shape.kind == 'train':
                state, _, optimizer = abstract_train_state(
                    bundle, mesh, rules_dict)
                args = (state, batch)
            else:
                params, axes = abstract_init(bundle)
                params = shd.place(params, shd.param_sharding_tree(
                    axes, params, mesh, rules.rules))
                args = (params, batch)
                if shape.kind == 'decode':
                    cache = _fake_cache(bundle, shape, mesh, rules)
                    cross = _fake_cross_kv(bundle, params, batch, shape,
                                           mesh, rules)
                    args = (params, cache, batch, cross)
        arg_bytes = _local_bytes(args)
        if shape.kind == 'train':
            step = make_train_step(
                bundle.loss_fn, optimizer, donate=True,
                microbatches=TRAIN_MICROBATCHES.get(arch, 1))
            out = step(*args)
        elif shape.kind == 'prefill':
            with torch.no_grad():
                out = bundle.forward(params, batch)
        else:
            with torch.no_grad():
                out = _decode(bundle, args, shape)
        out_bytes = _local_bytes(out)
    t_trace = time.time() - t0
    terms = analyze(mode.record, model_flops_per_chip=mflops)
    return {
        'arch': arch, 'shape': shape_name,
        'mesh': 'multi_pod_2x16x16' if multi_pod else 'single_pod_16x16',
        'kind': shape.kind, 'n_chips': n_chips,
        'params': n_params, 'active_params': n_active,
        'trace_s': round(t_trace, 1),
        'memory': {'argument_size_bytes': arg_bytes,
                   'output_size_bytes': out_bytes,
                   'temp_size_bytes': mode.record.peak_bytes},
        'roofline': terms.to_dict(),
        'cost': {'flops_by_dtype': dict(mode.record.flops_by_dtype),
                 'kernels': mode.record.kernels, 'ops': mode.record.ops,
                 'fallbacks': mode.record.fallbacks},
        'status': 'ok',
    }


def _fake_cache(bundle, shape, mesh, rules):
    """The decode cache (B = global_batch, max_seq = seq_len) as fake
    DTensors placed by the bundle's ``cache_axes``."""
    cfg = bundle.cfg
    cache = bundle.init_cache(shape.global_batch, shape.seq_len, 'cpu')
    lay = shd.param_sharding_tree(bundle.cache_axes(cfg), cache, mesh,
                                  rules.rules)
    return shd.place(cache, lay)


def _fake_cross_kv(bundle, params, batch, shape, mesh, rules):
    """The cross families' per-request K/V (audio: the encoder's, VLM: the
    patches'), made outside the step as the reference's dry run takes it
    as an input; placed like the cache ('layers', 'batch', 'kv_heads',
    'frames', 'head_dim')."""
    cfg = bundle.cfg
    if cfg.family not in ('audio', 'vlm'):
        return None
    from ..models import transformer
    src = torch.zeros((shape.global_batch, cfg.n_source_tokens,
                       cfg.d_model))
    src = shd.Layout(mesh, rules.spec(('batch', 'frames', 'embed'),
                                      src.shape)).distribute(src)
    kv = transformer.precompute_cross_kv(cfg, params, src)
    ax = ('layers', 'batch', 'kv_heads', 'frames', 'head_dim')
    return tree_map(lambda t: shd.Layout(mesh, rules.spec(ax, t.shape))
                    .distribute(shd.replicated(t).to_local()), kv)


def _decode(bundle, args, shape):
    params, cache, batch, cross = args
    tok = batch['frames' if bundle.cfg.family == 'lstm' else 'tokens']
    kw = {} if cross is None else {'cross_kv': cross}
    return bundle.decode_step(params, cache, tok, shape.seq_len - 1, **kw)


def cell_path(arch, shape_name, multi_pod):
    mesh = 'mp' if multi_pod else 'sp'
    return RESULTS / f'{arch}__{shape_name}__{mesh}.json'


def run_cell(arch, shape_name, multi_pod, force=False):
    """One cell: its cached record when one passed, else a fresh trace
    (status 'fail' with the traceback when it raises), written to
    ``cell_path``."""
    out = cell_path(arch, shape_name, multi_pod)
    if out.exists() and not force:
        rec = json.loads(out.read_text())
        if rec.get('status') == 'ok':
            print(f'[skip] {out.name} (cached)')
            return rec
    print(f'[run ] {arch} x {shape_name} '
          f'({"2x16x16" if multi_pod else "16x16"})', flush=True)
    t0 = time.time()
    try:
        rec = lower_cell(arch, shape_name, multi_pod)
        r, m = rec['roofline'], rec['memory']
        per_rank = (m['argument_size_bytes'] + m['temp_size_bytes'])
        print(f'  ok: {rec["trace_s"]} s, {per_rank / 1e9:.2f} GB a rank, '
              f'bottleneck={r["bottleneck"]}, '
              f'fraction={r["roofline_fraction"]}', flush=True)
    except Exception as e:
        rec = {'arch': arch, 'shape': shape_name,
               'mesh': 'multi_pod_2x16x16' if multi_pod else
               'single_pod_16x16', 'status': 'fail',
               'error': traceback.format_exc()}
        print(f'  FAIL: {type(e).__name__}: {str(e)[:300]}', flush=True)
    rec['wall_s'] = round(time.time() - t0, 1)
    RESULTS.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    return rec


def run_cells_parallel(cells, multi_pod: bool, force: bool, jobs: int):
    """``run_cell`` of each cell in a process of its own (one process group
    each), ``jobs`` at a time; their output interleaves by line.  Returns
    the records in cell order."""
    import subprocess
    import sys
    procs, done = {}, {}
    todo = list(cells)
    while todo or procs:
        while todo and len(procs) < jobs:
            arch, shape_name = todo.pop(0)
            cmd = [sys.executable, '-m', 'repro_torch.launch.dryrun',
                   '--arch', arch, '--shape', shape_name]
            cmd += ['--multi-pod'] * multi_pod + ['--force'] * force
            procs[(arch, shape_name)] = subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for cell, p in list(procs.items()):
            if p.poll() is not None:
                del procs[cell]
                path = cell_path(*cell, multi_pod)
                rec = (json.loads(path.read_text()) if path.exists() else
                       {'arch': cell[0], 'shape': cell[1], 'status': 'fail',
                        'error': f'exit code {p.returncode}, no record'})
                done[cell] = rec
                r = rec.get('roofline', {})
                print(f'[{rec["status"]}] {cell[0]} x {cell[1]}: '
                      f'{rec.get("wall_s")} s, '
                      f'bottleneck={r.get("bottleneck")}', flush=True)
        time.sleep(0.5)
    return [done[c] for c in cells]


def all_cells(include_chipmunk=True):
    cells = []
    for arch in ARCH_MODULES:
        if arch == 'chipmunk-ctc' and not include_chipmunk:
            continue
        cells += [(arch, s.name) for s in shapes_for(get_config(arch))]
    return cells


def _summary(rec) -> str:
    """status, wall s, GB a rank, bottleneck, roofline fraction."""
    if rec is None:
        return 'not run'
    if rec['status'] != 'ok':
        return 'fail: ' + rec['error'].strip().splitlines()[-1][:80]
    m, r = rec['memory'], rec['roofline']
    gb = (m['argument_size_bytes'] + m['temp_size_bytes']) / 1e9
    frac = r['roofline_fraction']
    return (f'ok, {rec["wall_s"]} s, {gb:.2f} GB, {r["bottleneck"]}, '
            f'{frac:.4f}' if frac is not None else
            f'ok, {rec["wall_s"]} s, {gb:.2f} GB, {r["bottleneck"]}, -')


def table() -> str:
    """Every cell's records on both meshes as markdown rows: status, wall
    seconds, the bytes a rank holds (arguments and the peak of
    temporaries), the bottleneck and the roofline fraction."""
    rows = ['| arch | shape | 16 x 16 | 2 x 16 x 16 |', '|---|---|---|---|']
    for arch, shape_name in all_cells():
        cells = []
        for mp in (False, True):
            path = cell_path(arch, shape_name, mp)
            cells.append(_summary(json.loads(path.read_text())
                                  if path.exists() else None))
        rows.append(f'| {arch} | {shape_name} | {cells[0]} | {cells[1]} |')
    return '\n'.join(rows)


def run_systolic_geometry():
    """The exchanges of the paper's 3 x (5 x 10) geometry: CTC-3L-421H-UNI
    pipelined over ('stage', 'row', 'col') = (3, 5, 10) engines
    (``core.pipeline``'s plan at tile 96), from the port's own systolic
    schedule (``core.pipeline.systolic_pipeline``) traced on fake tensors
    for T = 16 frames of B = 8 streams: the partial sums over columns, the
    h gathers over rows and the stage-to-stage hand-offs, each engine's
    share (the totals over the engines' count)."""
    from ..core import pipeline, systolic
    from ..core.lstm import init_lstm_stack
    cfg = get_config('chipmunk-ctc')
    T, B = 16, 8
    with op_cost.traced() as mode:
        with mode.hidden():
            params = init_lstm_stack(cfg.lstm_inputs, cfg.lstm_hidden,
                                     cfg.n_layers, None,
                                     torch.Generator().manual_seed(0))
            packed, plan = pipeline.pack_pipeline(list(params.layers),
                                                  tile=96)
            mesh = systolic.make_systolic_mesh(
                plan.rows, plan.cols, stage=cfg.n_layers, devices='cpu')
            xs = torch.zeros((T, B, plan.padded_x))
        with torch.no_grad():
            pipeline.systolic_pipeline(packed, mesh, xs)
    n = cfg.n_layers * plan.rows * plan.cols
    total = mode.record
    per = op_cost.CostRecord(bytes=total.bytes / n)
    for d, f in total.flops_by_dtype.items():
        per.flops_by_dtype[d] = f / n
    for k, b in total.coll.items():
        per.coll[k] = b / n
    terms = analyze(per)
    rec = {'arch': 'chipmunk-ctc',
           'shape': f'systolic_3x{plan.rows}x{plan.cols}',
           'mesh': f'stage3_row{plan.rows}_col{plan.cols}', 'status': 'ok',
           'n_chips': n, 'T': T, 'B': B, 'roofline': terms.to_dict(),
           'total_collective_bytes': dict(total.coll)}
    RESULTS.mkdir(parents=True, exist_ok=True)
    (RESULTS / 'chipmunk-ctc__systolic_geometry.json').write_text(
        json.dumps(rec, indent=1))
    print(f'  ok: {n} engines, collective bytes/engine='
          f'{terms.collective_bytes:,.0f} ({terms.per_collective})')
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--arch', choices=sorted(ARCH_MODULES))
    ap.add_argument('--shape', choices=sorted(SHAPES),
                    help='the cell\'s shape; with --all, only its cells')
    ap.add_argument('--multi-pod', action='store_true')
    ap.add_argument('--all', action='store_true')
    ap.add_argument('--force', action='store_true')
    ap.add_argument('--systolic', action='store_true',
                    help="the paper's 3x(RxC) geometry's collective bytes")
    ap.add_argument('--jobs', type=int, default=1,
                    help='with --all: cells traced at once, each in a '
                         'process of its own')
    ap.add_argument('--table', action='store_true',
                    help='print the records of every cell on both meshes '
                         'as a markdown table')
    args = ap.parse_args(argv)
    if args.table:
        print(table())
        return 0
    if args.systolic:
        run_systolic_geometry()
        return 0
    if args.all:
        cells = [c for c in all_cells()
                 if args.shape is None or c[1] == args.shape]
        recs = (run_cells_parallel(cells, args.multi_pod, args.force,
                                   args.jobs) if args.jobs > 1 else
                [run_cell(a, s, args.multi_pod, args.force)
                 for a, s in cells])
        fail = sum(r['status'] != 'ok' for r in recs)
        print(f'done: {len(recs) - fail} ok, {fail} failed')
        return 0 if not fail else 1
    if not (args.arch and args.shape):
        ap.error('give --arch and --shape, or --all, or --systolic')
    rec = run_cell(args.arch, args.shape, args.multi_pod, args.force)
    print(json.dumps({k: v for k, v in rec.items() if k != 'error'},
                     indent=1)[:3000])
    if rec['status'] != 'ok':
        print(rec['error'])
    return 0 if rec['status'] == 'ok' else 1


if __name__ == '__main__':
    raise SystemExit(main())
