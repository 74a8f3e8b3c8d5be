"""Logical-axis sharding rules and parameter placement over a
``torch.distributed`` ``DeviceMesh``.

Counterpart of ``repro.sharding``.  Model code names the axes of its
activations with ``logical(x, ...)`` and every bundle names its
parameters' and cache's axes (``models.registry``: ``param_axes``,
``cache_axes``).  A ``ShardingRules`` maps those logical names to mesh
axes; the dry run, the trainer and the loader install the rules for their
mesh and kind of step.  ``ShardingRules.spec`` is the reference's greedy
prefix rule, and gives the same per-dimension mesh axes as the
reference's ``PartitionSpec``; ``placements`` turns a spec into DTensor
placements (``Shard(d)`` on each mesh dimension that shards tensor
dimension d, ``Replicate()`` elsewhere).  A tensor dimension that two mesh
axes shard, ``('pod', 'data')``, is split over both in mesh order, as
JAX splits it major to minor.

Where the reference pads a dimension that an activation's mesh axes do
not divide (GSPMD), DTensor shards it unevenly; a parameter's spec only
takes mesh axes that divide its dimension, as the reference's does.
``logical`` is a no-op without rules, without a mesh, or on a plain
tensor; on a DTensor it redistributes to the rule's placements.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from .tree import flatten_with_paths

MeshAxes = Union[str, Tuple[str, ...], None]
Spec = Tuple[MeshAxes, ...]

# Logical axis vocabulary used across the model zoo.
#   batch      — global batch                   (DP: pod+data)
#   seq        — sequence/time                  (SP when enabled)
#   embed      — d_model residual stream        (FSDP dim for weights)
#   heads      — attention query heads          (TP)
#   kv_heads   — attention kv heads             (TP)
#   head_dim   — per-head feature dim
#   mlp        — FFN hidden dim                 (TP)
#   vocab      — embedding/logits vocabulary    (TP)
#   experts    — MoE expert dim                 (EP: pod+data)
#   expert_mlp — expert FFN hidden              (TP)
#   state      — recurrent state dim            (TP)
#   frames     — audio/image source positions
#   stage      — pipeline stage

TRAIN_RULES: Dict[str, MeshAxes] = {
    'batch': ('pod', 'data'),
    'seq': None,
    'embed': ('pod', 'data'),       # FSDP shard of params on the embed dim
    'heads': 'model',
    'kv_heads': 'model',
    'head_dim': 'model',            # fallback TP dim when head counts don't divide
    'mlp': 'model',
    'vocab': 'model',
    'experts': ('pod', 'data'),     # expert parallelism
    'expert_mlp': 'model',
    'state': 'model',
    'frames': None,
    'lstm_row': 'model',            # chipmunk systolic: output-row tiling
    'lstm_col': ('pod', 'data'),    # chipmunk systolic: input-column tiling
    # Attention activation policy (set per-arch by rules_for_arch):
    #   kv-heads divide TP  -> classic head-sharded attention
    #   otherwise           -> context parallelism: q seq sharded, K/V
    #                          replicated, scores local (no all-reduce)
    'seq_q': None,
    'kv_seq': None,
    'head_dim_act': None,           # NEVER shard the score contraction dim
    # MoE expert-buffer capacity dim: sharding it over TP keeps every
    # expert GEMM contraction local and divides the dispatch all-to-all by
    # the TP degree.
    'moe_cap': 'model',
}


def rules_for_arch(base: Dict[str, MeshAxes], n_kv_heads: int,
                   tp_size: int = 16, family: str = '') -> Dict[str, MeshAxes]:
    """Specialise the policy for an architecture (the reference's)."""
    r = dict(base)
    if n_kv_heads % tp_size != 0:
        r['seq_q'] = 'model'        # context-parallel scores
        r['kv_seq'] = 'model'       # flash-decoding-style cache split
    if family == 'lstm':
        # A 3.8M-param LSTM cannot use 16-way TP on a production mesh (421
        # hidden units shard nowhere): without this rule all 16 model ranks
        # compute the same batch.  Run pure DP over the whole mesh.
        r['batch'] = ('pod', 'data', 'model')
    return r


# Inference: no FSDP on embed (weights stay TP-sharded), batch over DP,
# experts over EP.
SERVE_RULES: Dict[str, MeshAxes] = {
    **TRAIN_RULES,
    'embed': None,
}

# Serving very large models (kimi-k2 1T, llama-90b-vision): weights must
# also shard over the data axes or they cannot fit.
SERVE_BIG_RULES: Dict[str, MeshAxes] = {
    **SERVE_RULES,
    'embed': ('pod', 'data'),
}


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (``mesh_dim_names``), or of
    any object with ``axis_names`` and ``devices.shape`` (a JAX mesh)."""
    if mesh is None:
        return {}
    if hasattr(mesh, 'mesh_dim_names'):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


class ShardingRules:
    def __init__(self, mesh, rules: Dict[str, MeshAxes]):
        self.mesh = mesh
        self.rules = dict(rules)

    def spec(self, axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> Spec:
        """Logical axes -> one entry per dimension: None, a mesh axis, or
        a tuple of mesh axes (the reference's ``PartitionSpec`` entries).

        Greedy left to right: each mesh axis at most once per spec, and
        with ``shape`` given a dimension claims only the longest prefix of
        its candidate mesh axes whose size product divides it."""
        used = set()
        out: List[MeshAxes] = []
        dims = list(shape) if shape is not None else [None] * len(axes)
        sizes = mesh_sizes(self.mesh)
        for a, dim in zip(axes, dims):
            v = self.rules.get(a) if a else None
            if v is None:
                out.append(None)
                continue
            cand = (v,) if isinstance(v, str) else tuple(v)
            best: Tuple[str, ...] = ()
            prod = 1
            cur = []
            for m in (m for m in cand if m not in used):
                cur.append(m)
                prod *= sizes.get(m, 1)
                if dim is None or (prod > 0 and dim % prod == 0):
                    best = tuple(cur)
            if best:
                used.update(best)
                out.append(best if len(best) > 1 else best[0])
            else:
                out.append(None)
        return tuple(out)

    def placements(self, axes: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None) -> tuple:
        """``spec(axes, shape)`` as DTensor placements on ``self.mesh``."""
        return spec_placements(self.spec(axes, shape), self.mesh)


def spec_placements(spec: Spec, mesh) -> tuple:
    """A spec's placements on ``mesh``: ``Shard(d)`` on every mesh
    dimension named by entry d, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, entry in enumerate(spec):
        for m in ((entry,) if isinstance(entry, str) else entry or ()):
            where[m] = d
    return tuple(Shard(where[m]) if m in where else Replicate()
                 for m in mesh.mesh_dim_names)


_CTX = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_CTX, 'rules', None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = current_rules()
    _CTX.rules = rules
    try:
        yield rules
    finally:
        _CTX.rules = prev


def is_dtensor(x) -> bool:
    # no DTensor exists before ``torch.distributed.tensor`` is imported: a
    # plain step's many calls cost a dict lookup, not an import
    mod = sys.modules.get('torch.distributed.tensor')
    return mod is not None and isinstance(x, mod.DTensor)


def logical(x: torch.Tensor, *axes: Optional[str],
            shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Place activation ``x`` by logical axis names: a no-op without rules,
    without a mesh or on a plain tensor; a DTensor is redistributed to the
    rules' placements where it is not there already.  ``shape``: the sizes
    the rules' divisibility test reads, where x's own differ (attention's
    heads, which shard as their kv-head groups do)."""
    r = current_rules()
    if r is None or r.mesh is None or not is_dtensor(x):
        return x
    if len(axes) != x.ndim:
        raise ValueError(f'logical: {len(axes)} axes {axes} for a tensor of '
                         f'shape {tuple(x.shape)}')
    want = r.placements(axes, x.shape if shape is None else shape)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def run_local(fn, args: Sequence, out_placements):
    """``fn(*args)`` on each rank's local shards, wrapped back into
    DTensors (``torch.distributed.tensor.experimental.local_map``): for a
    computation that is independent along every mesh dimension that
    shards an input (data parallel over the batch, attention per head or
    per query block).  ``args`` are DTensors on one mesh (or anything
    else, passed as is); ``out_placements`` one placement tuple per
    output (a tuple of them for several).  An input replicated along a
    mesh dimension that another input shards gets its gradient as a
    partial sum there (each shard's share), which autograd reduces."""
    from torch.distributed.tensor import (DTensor, Partial, Placement,
                                          Replicate, Shard)
    from torch.distributed.tensor.experimental import local_map
    if all(isinstance(p, Placement) for p in out_placements):
        out_placements = (tuple(out_placements),)     # one output
    dts = [a for a in args if isinstance(a, DTensor)]
    mesh = dts[0].device_mesh
    split = [any(isinstance(a.placements[m], Shard) for a in dts)
             for m in range(mesh.ndim)]
    in_pl, grad_pl = [], []
    for a in args:
        if not isinstance(a, DTensor):
            in_pl.append(None)
            grad_pl.append(None)
            continue
        in_pl.append(tuple(a.placements))
        grad_pl.append(tuple(
            Partial() if split[m] and isinstance(p, Replicate) else p
            for m, p in enumerate(a.placements)))
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl),
                     device_mesh=mesh)(*args)


def replicated(x):
    """A DTensor made whole on every rank (its placements all
    ``Replicate``); anything else as is."""
    from torch.distributed.tensor import Replicate
    if not is_dtensor(x):
        return x
    want = (Replicate(),) * x.device_mesh.ndim
    return x if tuple(x.placements) == want else x.redistribute(
        x.device_mesh, want)


def is_axes_leaf(v) -> bool:
    """A logical-axes leaf: a tuple of axis names and Nones."""
    return isinstance(v, tuple) and not hasattr(v, '_fields') and all(
        a is None or isinstance(a, str) for a in v)


def map_axes(fn, axes):
    """``fn`` over every axes leaf of an axes tree, the containers kept."""
    if is_axes_leaf(axes):
        return fn(axes)
    if isinstance(axes, dict):
        return {k: map_axes(fn, v) for k, v in axes.items()}
    if dataclasses.is_dataclass(axes):
        return dataclasses.replace(axes, **{
            f.name: map_axes(fn, getattr(axes, f.name))
            for f in dataclasses.fields(axes)})
    if hasattr(axes, '_fields'):
        return type(axes)(*(map_axes(fn, v) for v in axes))
    return type(axes)(map_axes(fn, v) for v in axes)


def axes_leaves(axes) -> List[Tuple[str, Tuple]]:
    """(path, axes) of every axes leaf, in the port's flattening order
    (``tree.flatten_with_paths``: dict keys sorted, fields in order)."""
    if is_axes_leaf(axes):
        return [('', axes)]
    if isinstance(axes, dict):
        kids = [(f"['{k}']", axes[k]) for k in sorted(axes)]
    elif hasattr(axes, '_fields'):
        kids = [(f'.{n}', getattr(axes, n)) for n in axes._fields]
    elif isinstance(axes, (tuple, list)):
        kids = [(f'[{i}]', c) for i, c in enumerate(axes)]
    else:
        kids = [(f'.{f.name}', getattr(axes, f.name))
                for f in dataclasses.fields(axes)]
    return [(step + p, a) for step, c in kids for p, a in axes_leaves(c)]


def param_specs(param_axes, params, mesh, rules: Dict[str, MeshAxes]
                ) -> Dict[str, Spec]:
    """{path: spec} of every leaf of ``params`` (tensors, or anything with
    a ``shape``) from its logical axes; raises on a mismatch of the two
    trees."""
    r = ShardingRules(mesh, rules)
    flat = flatten_with_paths(params)
    ax = axes_leaves(param_axes)
    if [p for p, _ in flat] != [p for p, _ in ax]:
        raise ValueError('param_specs: the axes tree does not match the '
                         'parameters leaf for leaf')
    out = {}
    for (path, leaf), (_, a) in zip(flat, ax):
        if len(a) != len(leaf.shape):
            raise ValueError(f'param_specs: {path} has axes {a} for shape '
                             f'{tuple(leaf.shape)}')
        out[path] = r.spec(a, tuple(leaf.shape))
    return out


class Layout:
    """Where one leaf lives: its ``mesh``, its ``spec`` and its DTensor
    ``placements``.  A leaf of the port's trees (not a container), so a
    tree of layouts maps leaf for leaf onto the tree it places."""

    def __init__(self, mesh, spec: Spec):
        self.mesh, self.spec = mesh, spec
        self.placements = spec_placements(spec, mesh)

    def __repr__(self) -> str:
        return f'Layout({self.spec})'

    def distribute(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (the full leaf, alike on every rank) as a DTensor of
        this layout: each rank keeps its shard.  A 0-d leaf (a step
        counter) stays a plain tensor."""
        from torch.distributed.tensor import distribute_tensor
        if t.ndim == 0:
            return t
        return distribute_tensor(t, self.mesh, list(self.placements),
                                 src_data_rank=None)


def param_sharding_tree(param_axes, params, mesh, rules: Dict[str, MeshAxes]):
    """A tree like ``params`` of each leaf's ``Layout`` on ``mesh``
    (divisibility-aware, as ``spec``)."""
    from .tree import unflatten_like
    specs = param_specs(param_axes, params, mesh, rules)
    return unflatten_like(params, [Layout(mesh, s) for s in specs.values()])


def place(tree, layouts):
    """Every leaf of ``tree`` distributed by the matching ``Layout`` of
    ``layouts`` (``param_sharding_tree``)."""
    from .tree import tree_map
    return tree_map(lambda t, lay: lay.distribute(t), tree, layouts)
