"""Shared harness of the port's fault-runtime parity tests
(``tests/test_torch_serving_faults.py``, ``tests/test_torch_recovery.py``):
one fault schedule replayed on the reference's SYNC engine and on the
port's engine, at the smoke size, with the same weights (the reference's,
through ``repro_torch.convert``) and the same utterances.

A case names the reference backend (the port runs its counterpart under
``NAME_MAP``), the engine's packing, the utterances, the
``ServingFaultConfig`` keywords and the control ops applied before the
drain.  Events are compared whole after ``normalize``: backend names
mapped, wall times (``dt``) dropped, and the runner's ``straggler`` events
dropped (they classify wall times, which differ between the two engines).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np

import jax

from repro import configs as jconfigs
from repro.models import chipmunk_net as jnet
from repro.runtime import ServingFaultConfig as JFaultConfig
from repro.serving import StreamingEngine as JEngine
from repro_torch import configs
from repro_torch.convert import stack_params_from_numpy
from repro_torch.runtime import ServingFaultConfig
from repro_torch.serving import StreamingEngine

RTOL, ATOL = 1e-5, 1e-6
# reference backend -> the port's counterpart
NAME_MAP = {'pallas_seq_fused': 'cuda_seq_fused', 'pallas_seq': 'cuda_seq',
            'pallas_step': 'cuda_step', 'xla_scan': 'torch_scan',
            'pallas_seq_systolic': 'cuda_seq_systolic',
            'pallas_seq_fused_systolic': 'cuda_seq_fused_systolic',
            'auto': 'auto'}
TIMED_KINDS = ('straggler',)


@functools.lru_cache(maxsize=None)
def smoke():
    """(JAX cfg, JAX params, port cfg, port params on the CPU), made once."""
    jcfg = jconfigs.get_smoke_config('chipmunk-ctc')
    jparams, _ = jnet.init(jcfg, jax.random.PRNGKey(0))
    cfg = configs.get_smoke_config('chipmunk-ctc')
    params = stack_params_from_numpy(jax.tree.map(np.asarray, jparams), 'cpu')
    return jcfg, jparams, cfg, params


def utts_ramp(n: int, seed: int = 0):
    """The reference's ``tests/test_serving_faults.py`` utterances: n of
    30 + 7 i frames."""
    n_in = smoke()[2].lstm_inputs
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((30 + 7 * i, n_in)).astype(np.float32) * 0.5
            for i in range(n)]


def utts_flat(n: int, frames: int, seed: int = 0):
    """The reference's ``tests/test_recovery.py`` utterances: n of
    ``frames`` frames."""
    n_in = smoke()[2].lstm_inputs
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((frames, n_in)).astype(np.float32) * 0.5
            for _ in range(n)]


@dataclasses.dataclass(frozen=True)
class Case:
    """One fault schedule: reference ``backend``, packing, utterances
    (``('ramp', n, seed)`` or ``('flat', n, frames)``), fault-config
    keywords as sorted items, control ops run before the drain
    (``('step',)``, ``('preempt', sid)``, ``('evict_resume', sid)``), and
    ``reject_canary`` (every canary comparison forced to fail)."""
    backend: str
    slots: int
    chunk: int
    utts: Tuple
    faults: Tuple
    ops: Tuple = ()
    reject_canary: bool = False

    def make_utts(self):
        kind, n, arg = self.utts
        return utts_ramp(n, arg) if kind == 'ramp' else utts_flat(n, arg)


def case(backend, utts, slots=2, chunk=8, ops=(), reject_canary=False,
         **faults):
    return Case(backend, slots, chunk, utts, tuple(sorted(faults.items())),
                tuple(ops), reject_canary)


def drive(eng, utts, ops):
    """Submit ``utts`` (sids 0..n-1), apply ``ops``, drain.  Returns
    ``({sid: (log-probs, errored)}, stats)``."""
    sessions = [eng.submit(u, sid=i) for i, u in enumerate(utts)]
    for op in ops:
        if op[0] == 'step':
            eng.step()
        elif op[0] == 'preempt':
            eng.preempt(op[1])
        elif op[0] == 'evict_resume':
            eng.resume(eng.evict(op[1]))
        else:
            raise ValueError(op)
    eng.run()
    out = {s.sid: (s.full_log_probs(), s.error is not None)
           for s in sessions}
    return out, eng.stats()


def run_reference(c: Case):
    """The reference's sync engine on case ``c``."""
    jcfg, jparams, _, _ = smoke()
    eng = JEngine(jcfg.replace(lstm_backend=c.backend), jparams,
                  max_streams=c.slots, chunk=c.chunk,
                  faults=JFaultConfig(**dict(c.faults)))
    if c.reject_canary:
        eng._canary_equal = lambda a, b: False
    return drive(eng, c.make_utts(), c.ops)


def reference_cache():
    """``run_reference`` behind a cache keyed by the case (its fault
    config holds dicts, so the key is its repr): each schedule runs on the
    reference once per test module."""
    cache = {}

    def run(c: Case):
        key = repr(c)
        if key not in cache:
            cache[key] = run_reference(c)
        return cache[key]

    return run


def make_engine(c: Case, async_dispatch: bool = False,
                faults: Optional[dict] = None):
    """The port's engine on case ``c`` (``faults`` overrides the case's
    keywords)."""
    _, _, cfg, params = smoke()
    kw = dict(c.faults) if faults is None else faults
    eng = StreamingEngine(cfg.replace(lstm_backend=NAME_MAP[c.backend]),
                          params, max_streams=c.slots, chunk=c.chunk,
                          faults=ServingFaultConfig(**kw),
                          async_dispatch=async_dispatch)
    if c.reject_canary:
        eng._canary_equal = lambda a, b: False
    return eng


def run_port(c: Case, async_dispatch: bool = False):
    return drive(make_engine(c, async_dispatch), c.make_utts(), c.ops)


def normalize(events, drop_keys=('dt',)):
    """Events as comparable dicts: timing-only kinds and keys dropped,
    reference backend names mapped to the port's."""
    out = []
    for e in events:
        if e['kind'] in TIMED_KINDS:
            continue
        e = {k: NAME_MAP.get(v, v) if isinstance(v, str) else v
             for k, v in e.items() if k not in drop_keys}
        out.append(e)
    return out


def untimed_counts(counts, skip=()):
    """An engine's ``event_counts`` without the timing-only kinds
    (``TIMED_KINDS``: a ``straggler`` is a chunk that took over 3x the
    running mean of wall time, so a loaded host adds one to one run and
    not to another) and without ``skip``."""
    return {k: v for k, v in counts.items()
            if k not in TIMED_KINDS + tuple(skip)}


def kinds(events, skip=()):
    return [e['kind'] for e in events
            if e['kind'] not in TIMED_KINDS + tuple(skip)]


def assert_matches_reference(got, ref):
    """Port run ``got`` against reference run ``ref``: the same events
    (``normalize``), the same streams with the same quarantine verdicts,
    and every stream allclose (rtol 1e-5, atol 1e-6)."""
    (out, stats), (rout, rstats) = got, ref
    assert normalize(stats['events']) == normalize(rstats['events'])
    assert stats['rung'] == NAME_MAP[rstats['rung']]
    assert stats['healthy_domains'] == rstats['healthy_domains']
    assert stats['deadline_misses'] == rstats['deadline_misses']
    assert set(out) == set(rout)
    for sid, (lp, err) in out.items():
        rlp, rerr = rout[sid]
        assert err == rerr, sid
        np.testing.assert_allclose(lp, rlp, rtol=RTOL, atol=ATOL,
                                   err_msg=f'sid={sid}')


def assert_bit_equal(a, b):
    """Two port runs: the same events (``normalize``; the async engine's
    ``squash`` events aside), the same streams, verdicts and log-prob
    bits."""
    (out_a, st_a), (out_b, st_b) = a, b

    def trail(st):
        return [e for e in normalize(st['events']) if e['kind'] != 'squash']

    assert trail(st_a) == trail(st_b)
    assert set(out_a) == set(out_b)
    for sid in out_a:
        assert out_a[sid][1] == out_b[sid][1], sid
        np.testing.assert_array_equal(out_a[sid][0], out_b[sid][0],
                                      err_msg=f'sid={sid}')
