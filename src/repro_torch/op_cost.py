"""A cost model over a traced step: FLOPs by dtype, HBM bytes, collective
bytes and the peak of live memory, per rank.

Counterpart of ``repro.hlo_cost``.  The reference walks the optimized HLO
of a compiled step (trip counts and all); PyTorch has no such program, so
this module traces the step itself: ``CostMode`` is a
``TorchDispatchMode`` that sees every ATen op the step runs on one rank.
Run the step on DTensors over a fake process group and under
``FakeTensorMode`` (``launch.dryrun``), and nothing is allocated or
computed while the record fills:

  * flops — 2·M·N·K for a matrix product, one an element for anything
    elementwise, one an input element for a reduction, charged to the dtype
    of the op's operands (the card's peak differs by dtype: ``roofline``);
  * bytes — each op's tensor operands read once and its outputs written
    once; views are free, and an in-place write into a slice (``copy_``,
    ``fill_``, ``zero_``) moves the slice's bytes, not its base's;
  * collectives — the operand bytes of every ``_c10d_functional`` op
    (all-gather, reduce-scatter, all-reduce, all-to-all), the ops DTensor
    redistributes with;
  * memory — the storages the step allocates, live until freed, and their
    peak (``peak_bytes``).

The mode counts the **local shards**: it returns ``NotImplemented`` to a
DTensor op, DTensor dispatches it, and the ops on each rank's local
tensors come back through the mode.  DTensor also runs every new op once
on global-shaped stand-ins to learn its output's metadata (built by
``empty_strided``); ops on those stand-ins alone are not counted.

A hand-written kernel (K1, K2, K8 and K8's backward pair) is not charged by
its plain PyTorch version: off the card each wrapper runs the custom op
``repro_torch::<kernel>`` (the plain version, and under fake tensors its
fake implementation's outputs), and the mode charges that op by name from
``KERNEL_COSTS``: the FLOPs and bytes of its launch geometry (the same
reckoning as the bound column of ``chip_smoke.py``'s kernel line; K2
each launch of its ``lb``-layer groups, ``stack_launch_costs``; K8's
FLOPs from the query x key tiles its schedule computes,
``kernels.flash_attention.attention_cost``).

A loop over time steps (the LSTM's hoisted products and read-out, its
reverse-time backward, the CTC recursion, the sLSTM scan) runs its body
once and counts it as many times as the loop turns (``steps`` and
``stack_steps``), as the reference's walker weights a loop body by its
trip count; the ops of that body's backward (autograd nodes made inside
it) are weighted alike.  The storage such a body allocates is tracked
once (a lower bound where every step keeps its activations for the
backward, as the CTC recursion and the sLSTM scan do).

``estimate_backend_us`` / ``rank_stack_backends`` are the reference's
backend-ranking oracle over this model: one ``lstm_stack_apply`` launch of
each stack backend traced on fake tensors and priced at the card's rates.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map_only

aten = torch.ops.aten

COLLECTIVES = {
    'all_gather_into_tensor': 'all-gather',
    'all_gather_into_tensor_coalesced': 'all-gather',
    'reduce_scatter_tensor': 'reduce-scatter',
    'reduce_scatter_tensor_coalesced': 'reduce-scatter',
    'all_reduce': 'all-reduce',
    'all_reduce_coalesced': 'all-reduce',
    'all_to_all_single': 'all-to-all',
    'shard_dim_alltoall': 'all-to-all',
    'broadcast': 'collective-permute',
}

# ops that move no bytes and do no arithmetic: metadata, fresh storage
_FREE = {'empty', 'empty_like', 'empty_strided', 'new_empty',
         'new_empty_strided', 'detach', 'alias', 'lift_fresh', 'set_',
         'resize_', 'wait_tensor', 'sym_size', 'sym_stride', 'sym_numel',
         'sym_storage_offset', 'is_same_size', 'device', 'dim',
         '_local_scalar_dense', 'record_stream'}
# ops that move data and do no arithmetic
_MOVE = {'copy_', '_to_copy', 'clone', 'cat', 'stack', 'index',
         'index_select', 'gather', 'scatter', 'scatter_', 'index_put',
         'index_put_', 'embedding', 'embedding_dense_backward', 'fill_',
         'zero_', 'zeros', 'zeros_like', 'ones', 'ones_like', 'full',
         'full_like', 'new_zeros', 'new_ones', 'new_full', 'arange',
         'contiguous', 'constant_pad_nd', 'slice_scatter', 'select_scatter',
         'masked_fill', 'masked_fill_', 'where', 'repeat', 'flip', 'roll',
         'tril', 'triu', 'gather_backward', 'index_add', 'index_add_',
         'scatter_add', 'scatter_add_', 'split_with_sizes_copy',
         'unbind_copy', 'sort', 'argsort', 'topk', 'searchsorted'}
# ops whose first argument is written and not read
_OVERWRITE = {'copy_', 'fill_', 'zero_'}
# reductions: one flop an input element
_REDUCE = {'sum', 'mean', 'amax', 'amin', 'max', 'min', 'logsumexp', 'var',
           'std', 'prod', 'norm', 'linalg_vector_norm', 'cumsum', 'any',
           'all', '_log_softmax', '_softmax', '_log_softmax_backward_data',
           '_softmax_backward_data', 'var_mean', 'native_layer_norm',
           'native_layer_norm_backward'}


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def _strided_dims(out) -> set:
    """The mesh dims on which an output DTensor is a strided shard."""
    from torch.distributed.tensor.placement_types import _StridedShard
    return {m for o in tree_leaves(out) if isinstance(o, _dtensor_type())
            for m, p in enumerate(o.placements)
            if isinstance(p, _StridedShard)}


def _whole_local(t) -> torch.Tensor:
    """DTensor ``t`` gathered whole on this rank from its shards by the
    functional collectives themselves (inner mesh dims first, as DTensor
    splits a dim in mesh order; partial sums all-reduced), the gathered
    dims cut to the global size (an uneven split's rank 0 holds the
    largest chunk).  For fake tensors: shapes and counted bytes."""
    import torch.distributed._functional_collectives as funcol
    x, mesh = t._local_tensor.contiguous(), t.device_mesh
    for m in reversed(range(mesh.ndim)):
        p = t.placements[m]
        if p.is_shard():
            x = funcol.all_gather_tensor(x.contiguous(), p.dim, (mesh, m))
        elif p.is_partial():
            x = funcol.all_reduce(x, 'sum', (mesh, m))
        x = funcol.wait_tensor(x) if isinstance(
            x, funcol.AsyncCollectiveTensor) else x
    for d, n in enumerate(t.shape):
        if x.shape[d] != n:
            x = x.narrow(d, 0, n)
    return x


def _whole_on(t, dims: set):
    """DTensor ``t`` replicated on mesh ``dims``."""
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if m in dims else p for m, p in enumerate(t.placements)]
    return t if pl == list(t.placements) else t.redistribute(t.device_mesh,
                                                               pl)


def _no_sharding(e: Exception) -> bool:
    """Whether ``e`` is DTensor's refusal to shard an op as placed."""
    msg = str(e)
    return ('Sharding propagation failed' in msg
            or 'does not have a sharding strategy' in msg
            or 'unevenly sharded' in msg)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(name: str, args) -> Optional[float]:
    """2·M·N·K (batched) of a product op, None for anything else."""
    if name == 'mm':
        a, b = args[0], args[1]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name == 'addmm':
        a, b = args[1], args[2]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1] \
            + a.shape[0] * b.shape[1]
    if name in ('bmm', 'baddbmm'):
        a, b = (args[0], args[1]) if name == 'bmm' else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    return None


@dataclasses.dataclass
class CostRecord:
    """What one rank's traced step costs (see the module docstring)."""
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(float))
    bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(float))
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    peak_bytes: int = 0
    live_bytes: int = 0
    ops: int = 0
    # DTensor ops whose inputs were made whole first (``CostMode``)
    fallbacks: Dict[str, int] = dataclasses.field(default_factory=dict)
    # (kind, op name) -> [flops, bytes]; kind 'op', 'coll' or 'kernel'
    by_op: Dict[Tuple[str, str], List[float]] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(lambda: [0.0, 0.0]))

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.coll.values()))

    def to_dict(self) -> Dict:
        return {'flops': self.flops,
                'flops_by_dtype': dict(self.flops_by_dtype),
                'bytes': self.bytes, 'per_collective': dict(self.coll),
                'kernels': self.kernels, 'peak_bytes': self.peak_bytes,
                'ops': self.ops, 'fallbacks': dict(self.fallbacks)}


def _seq_cost(pre_x, w_h, *_):
    from .kernels.lstm_seq.kernel import seq_launch_cost
    T, B, _, N = pre_x.shape
    return seq_launch_cost(T, B, N, 1, w_h.numel())


def _stack_seq_cost(pre_x, w_in, w_h, peep, bias, h0, c0, mask, lb):
    from .kernels.lstm_seq.stack_kernel import stack_launch_costs
    T, B, _, N = pre_x.shape
    L = w_h.shape[0]
    costs = stack_launch_costs(T, B, N, L, lb)
    return (sum(f for f, _ in costs), sum(b for _, b in costs),
            torch.float32, L // lb)


def _attention_cost(q, k, v, causal, window, sm_scale, kv_len, offset,
                    return_lse):
    from .kernels.flash_attention.kernel import attention_cost
    from .launch.mesh import SMS
    b, h, sq, d = q.shape
    return attention_cost(b, h, k.shape[1], sq, k.shape[2], d, q.dtype,
                          causal=causal, window=window, kv_len=kv_len,
                          offset=offset, return_lse=return_lse, sms=SMS)


def _attention_bwd_cost(which: str):
    def cost(q, k, v, do, lse, delta, causal, window, sm_scale, offset):
        from .kernels.flash_attention.kernel import attention_bwd_cost
        from .launch.mesh import SMS
        b, h, sq, d = q.shape
        return attention_bwd_cost(which, b, h, k.shape[1], sq, k.shape[2],
                                  d, q.dtype, causal=causal, window=window,
                                  offset=offset, sms=SMS)
    return cost


#: op name (``repro_torch::<name>``) -> its arguments -> (FLOPs, bytes,
#: dtype) of the kernel launch it stands for, or (FLOPs, bytes, dtype,
#: launches) of the launches it stands for (K2 in layer groups)
KERNEL_COSTS: Dict[str, Callable[..., Tuple[float, float, torch.dtype]]] = {
    'lstm_seq': _seq_cost,
    'lstm_stack_seq_kernel': _stack_seq_cost,
    'flash_attention': _attention_cost,
    'flash_attention_bwd_kv': _attention_bwd_cost('kv'),
    'flash_attention_bwd_q': _attention_bwd_cost('q'),
}

_ACTIVE: List['CostMode'] = []


def recording() -> Optional['CostMode']:
    """The innermost active ``CostMode``, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


class CostMode(TorchDispatchMode):
    """Records the cost of every op run inside it into ``self.record``.
    Enter it inside ``FakeTensorMode`` (the fake mode first)."""

    def __init__(self):
        super().__init__()
        self.record = CostRecord()
        self._hidden = 0
        self._live: Dict[int, List[int]] = {}    # storage -> [bytes, refs]
        self._in_dtensor = False
        self.scale = 1.0         # the trip count of the enclosing loops
        # (first, last autograd sequence number, weight) of loop bodies
        self.regions: List[Tuple[int, int, float]] = []

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def hidden(self):
        """Ops run inside are not counted."""
        self._hidden += 1
        try:
            yield
        finally:
            self._hidden -= 1

    # ------------------------------------------------------------ DTensor
    def _dtensor_op(self, func, args, kwargs):
        """A DTensor op, dispatched by DTensor with this mode back on the
        stack (so its local ops and collectives are counted).  Where
        DTensor has no sharding for the op on its inputs' placements (a
        reshape that would split a sharded dimension unevenly, an op with
        no strategy), the inputs are made whole first, as GSPMD pads:
        correct, with the all-gathers counted; ``record.fallbacks`` counts
        such ops by name."""
        self._in_dtensor = True
        try:
            with self:
                try:
                    out = func(*args, **kwargs)
                    strided = _strided_dims(out)
                    if not strided:
                        return out
                    # a view that merged a sharded dimension into a
                    # strided shard: make the inputs whole on those mesh
                    # dims and view again
                    name = func._schema.name.split('::')[-1] + ' (strided)'
                    self.record.fallbacks[name] = \
                        self.record.fallbacks.get(name, 0) + 1
                    args, kwargs = tree_map_only(
                        _dtensor_type(), lambda t: _whole_on(t, strided),
                        (args, kwargs))
                    return func(*args, **kwargs)
                except (RuntimeError, NotImplementedError) as e:
                    if not _no_sharding(e):
                        raise
                    if func is aten.detach_.default:
                        # the autograd metadata is handled above dispatch;
                        # the shards need nothing
                        return args[0]
                    name = func._schema.name.split('::')[-1]
                    self.record.fallbacks[name] = \
                        self.record.fallbacks.get(name, 0) + 1
                    dt = _dtensor_type()
                    mesh = next(a for a in tree_leaves((args, kwargs))
                                if isinstance(a, dt)).device_mesh
                    args, kwargs = tree_map_only(dt, _whole_local,
                                                 (args, kwargs))
                    out = func(*args, **kwargs)
                    from torch.distributed.tensor import Replicate
                    whole = [Replicate()] * mesh.ndim
                    return tree_map_only(
                        torch.Tensor, lambda t: dt.from_local(
                            t, mesh, whole, run_check=False), out)
        finally:
            self._in_dtensor = False

    # ------------------------------------------------------------ memory
    def _free(self, key: int) -> None:
        ent = self._live.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            del self._live[key]
            self.record.live_bytes -= ent[0]

    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except Exception:                    # a tensor with no storage
            return
        key = st._cdata
        ent = self._live.get(key)
        if ent is None:
            ent = self._live[key] = [st.nbytes(), 0]
            self.record.live_bytes += ent[0]
            self.record.peak_bytes = max(self.record.peak_bytes,
                                         self.record.live_bytes)
        ent[1] += 1
        weakref.finalize(t, self._free, key)

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            if self._in_dtensor:
                return NotImplemented        # counted on the local shards
            return self._dtensor_op(func, args, kwargs)
        out = func(*args, **kwargs)
        if self._hidden:
            return out
        ins = [a for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        name = func._schema.name.split('::')[-1]
        if name == 'empty_strided' and not ins:
            for o in outs:
                o._cost_stand_in = True
            return out
        if ins and all(getattr(a, '_cost_stand_in', False) for a in ins):
            for o in outs:
                o._cost_stand_in = True
            return out
        self._count(func, name, args, ins, outs)
        return out

    def _weight(self) -> float:
        """The weight of the op being counted: the enclosing loops' trip
        counts, and in a backward that of the loop body whose autograd
        node runs."""
        w = self.scale
        node = torch._C._current_autograd_node()
        if node is not None and self.regions:
            seq = node._sequence_nr()
            for lo, hi, scale in self.regions:
                if lo < seq < hi:
                    w *= scale
        return w

    def _count(self, func, name: str, args, ins, outs) -> None:
        rec = self.record
        w = self._weight()
        ns = func.namespace
        if ns == 'repro_torch':
            flops, nbytes, dtype, *launches = KERNEL_COSTS[name](*args)
            self.charge(name, w * flops, w * nbytes, dtype,
                        w * (launches[0] if launches else 1))
            for o in outs:
                self._track(o)
            return
        if ns in ('_c10d_functional', 'c10d_functional', '_dtensor'):
            kind = COLLECTIVES.get(name)
            if kind is not None:
                b = w * sum(_nbytes(a) for a in ins)
                rec.coll[kind] += b
                rec.bytes += b + w * sum(_nbytes(o) for o in outs)
                rec.by_op[('coll', kind)][1] += b
                for o in outs:
                    self._track(o)
            return
        if func.is_view or name in _FREE or ns == 'prim':
            return
        rec.ops += w
        mutated = set()
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write \
                    and i < len(args) and isinstance(args[i], torch.Tensor):
                mutated.add(id(args[i]))
        read = [a for a in ins
                if not (name in _OVERWRITE and id(a) in mutated)]
        nb = sum(_nbytes(a) for a in read) + sum(_nbytes(o) for o in outs)
        flops = _matmul_flops(name, args)
        if flops is None:
            if name in _MOVE:
                flops = 0.0
            elif name in _REDUCE:
                flops = float(sum(a.numel() for a in ins[:1]))
            else:
                flops = float(sum(o.numel() for o in outs
                                  if o.is_floating_point()))
        flops, nb = flops * w, nb * w
        if flops:
            src = next((a for a in ins if a.is_floating_point()),
                       ins[0] if ins else outs[0])
            rec.flops_by_dtype[str(src.dtype).split('.')[-1]] += flops
        rec.bytes += nb
        ent = rec.by_op[('op', name)]
        ent[0] += flops
        ent[1] += nb
        if not mutated:
            for o in outs:
                self._track(o)

    # ------------------------------------------------------------ kernels
    def charge(self, name: str, flops: float, nbytes: float,
               dtype: torch.dtype, launches: float = 1) -> None:
        """``launches`` launches of hand-written kernel ``name``."""
        rec = self.record
        rec.flops_by_dtype[str(dtype).split('.')[-1]] += flops
        rec.bytes += nbytes
        k = rec.kernels.setdefault(name, {'launches': 0, 'flops': 0.0,
                                          'bytes': 0.0})
        k['launches'] += launches
        k['flops'] += flops
        k['bytes'] += nbytes
        ent = rec.by_op[('kernel', name)]
        ent[0] += flops
        ent[1] += nbytes


def collective(kind: str, operands) -> None:
    """Count an exchange between engines that one process runs (the
    systolic scale-out's psum, all-gather and ppermute, which are device
    copies here): the operands' bytes under ``kind``, while a ``CostMode``
    records."""
    mode = recording()
    if mode is None or mode._hidden:
        return
    b = mode._weight() * sum(_nbytes(t) for t in operands)
    mode.record.coll[kind] += b
    mode.record.by_op[('coll', kind)][1] += b


def _sequence_mark() -> int:
    """The autograd sequence number a node made now would take."""
    with torch.enable_grad():
        x = torch.zeros((), requires_grad=True)
        return (x * 1).grad_fn._sequence_nr()


def steps(indices, like: torch.Tensor):
    """The loop ``for t in indices``.  While a ``CostMode`` records and
    ``like`` is a fake tensor, only the first index comes, and what the
    body runs (its backward too) counts ``len(indices)`` times; build the
    loop's stacked outputs with ``stack_steps``."""
    idx = list(indices)
    mode = recording()
    if mode is None or len(idx) <= 1 or not _is_fake(like):
        yield from idx
        return
    n = len(idx)
    with mode.hidden():
        lo = _sequence_mark()
    mode.scale *= n
    try:
        yield idx[0]
    finally:
        mode.scale /= n
        with mode.hidden():
            mode.regions.append((lo, _sequence_mark(), n))


def stack_steps(ys: List[Optional[torch.Tensor]], n: int,
                dim: int = 0) -> torch.Tensor:
    """``torch.stack`` of a loop's n per-step outputs; after a ``steps``
    loop that ran one body, its one output repeated n times."""
    got = [y for y in ys if y is not None]
    if len(got) == n:
        return torch.stack(got, dim)
    y = got[0].unsqueeze(dim)
    shape = list(y.shape)
    shape[dim] = n
    return y.expand(shape).clone()


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t)


@contextlib.contextmanager
def _all_to_all_kept():
    """DTensor on a CPU mesh turns a shard-to-shard all-to-all into an
    all-gather and a chunk (gloo has none); on fake tensors the all-to-all
    op has a fake implementation, so a trace keeps it an all-to-all (its
    bytes, not the whole tensor's)."""
    try:
        from torch.distributed.tensor import placement_types as pt
        orig = pt.shard_dim_alltoall
        op = torch.ops._dtensor.shard_dim_alltoall
    except (ImportError, AttributeError):
        yield
        return

    def a2a(input, gather_dim, shard_dim, mesh, mesh_dim):
        if not _is_fake(input):
            return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        return op(input, gather_dim, shard_dim,
                  mesh.get_group(mesh_dim).group_name)

    pt.shard_dim_alltoall = a2a
    try:
        yield
    finally:
        pt.shard_dim_alltoall = orig


@contextlib.contextmanager
def traced():
    """``FakeTensorMode`` with a ``CostMode`` inside: yields the mode,
    whose ``record`` holds the cost of what ran inside."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True), _all_to_all_kept():
        with CostMode() as mode:
            yield mode


def top_contributors(record: CostRecord, k: int = 12):
    """(collectives, memory ops, FLOP ops): the ``k`` largest per op of
    each, as (amount, op name) — the reference's profiling view."""
    coll = sorted(((v[1], n) for (kind, n), v in record.by_op.items()
                   if kind == 'coll'), reverse=True)[:k]
    mem = sorted(((v[1], n) for (kind, n), v in record.by_op.items()
                  if kind != 'coll'), reverse=True)[:k]
    flops = sorted(((v[0], n) for (kind, n), v in record.by_op.items()
                    if kind != 'coll' and v[0]), reverse=True)[:k]
    return coll, mem, flops


# ---------------------------------------------------------------------------
# Backend ranking oracle
# ---------------------------------------------------------------------------
#: Stack backends the oracle ranks by default: every backend whose launch
#: needs no systolic mesh.
NON_STAGED_STACK_BACKENDS = ('torch_scan', 'cuda_seq', 'cuda_seq_fused')


def stack_launch_cost(backend: str, n_x: int, n_h: int, n_layers: int,
                      T: int, B: int) -> CostRecord:
    """The cost of one ``lstm_stack_apply`` launch on ``backend`` (T steps,
    B streams, no read-out), traced on fake tensors: the plain scan op by
    op, a kernel backend by its kernels' launch geometry."""
    from .core.lstm import init_lstm_stack, lstm_stack_apply
    with traced() as mode:
        with mode.hidden():
            params = init_lstm_stack(n_x, n_h, n_layers, None,
                                     torch.Generator().manual_seed(0))
            xs = torch.zeros((T, B, n_x))
        with torch.no_grad():
            lstm_stack_apply(params, xs, backend=backend)
    return mode.record


def estimate_backend_us(backend: str, n_x: int, n_h: int, n_layers: int,
                        T: int, B: int) -> float:
    """Cost-model time estimate (µs) of one backend's stack launch: the
    no-overlap sum compute + memory + collective at the card's rates (FLOPs
    at their dtype's peak).  An estimate for ranking, not a bound: a launch
    takes at least ``roofline``'s ``step_time_lower_bound_s`` (the largest
    term)."""
    from .roofline import analyze
    t = analyze(stack_launch_cost(backend, n_x, n_h, n_layers, T, B))
    return (t.compute_s + t.memory_s + t.collective_s) * 1e6


def rank_stack_backends(n_x: int, n_h: int, n_layers: int, T: int, B: int,
                        backends: Optional[Tuple[str, ...]] = None
                        ) -> List[Tuple[str, float]]:
    """Backends with their estimates, best first; ties break on the name.
    A backend that cannot trace here (an admission error) is skipped."""
    scored = []
    for b in backends or NON_STAGED_STACK_BACKENDS:
        try:
            scored.append((b, estimate_backend_us(b, n_x, n_h, n_layers, T,
                                                  B)))
        except (ValueError, NotImplementedError, RuntimeError):
            continue
    return sorted(scored, key=lambda su: (su[1], su[0]))
