"""A streaming entry under a closed backlog: every request is due at t = 0
and the client keeps ``queue_depth`` of them waiting in the server's queue
(a request is submitted as soon as one is admitted), stepping the engine
itself.  Warm-up for ``warmup_s``, the window for ``seconds``, then
(traced runs) ``trace_s`` more.

Every request that retires in the window counts; of those, the ones drawn
from the seed (a ``sample.share`` of them) and the longest keep their
outputs for the comparison, the others drop them as they retire.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bench import gen
from bench.readers import Traced


@dataclasses.dataclass
class _Req:
    i: int
    length: int
    sess: object = None
    t_done: Optional[float] = None
    eligible: bool = False
    kept: bool = False


class _Run:
    """Submissions, steps, and which retired requests keep their
    outputs."""

    def __init__(self, system, traffic: gen.Traffic, pool: np.ndarray,
                 share: float, seed: int):
        self.sys, self.traffic, self.pool = system, traffic, pool
        self.reqs: List[_Req] = []
        self.by_sid: Dict[int, _Req] = {}
        self.next_i = 0
        self.done_frames = 0
        self.share = share
        self._mark = gen.rng_for(seed, 'sample')
        self._marks: List[float] = []
        self.longest: Optional[_Req] = None
        self.window_open = False

    def marked(self, i: int) -> bool:
        while len(self._marks) <= i:
            self._marks.extend(self._mark.random(4096).tolist())
        return self._marks[i] < self.share

    def submit(self) -> None:
        i = self.next_i
        self.next_i += 1
        L, off = self.traffic.length(i), self.traffic.offset(i)
        r = _Req(i=i, length=L)
        with torch.profiler.record_function('bench.submit'):
            r.sess = self.sys.submit(self.pool[off:off + L])
        self.by_sid[r.sess.sid] = r
        self.reqs.append(r)

    def step(self) -> None:
        with torch.profiler.record_function('bench.step'):
            self.sys.step()
        now = time.perf_counter()
        for sess in self.sys.new_done():
            r = self.by_sid.get(sess.sid)
            if r is None:             # a stream of the kernels' warm-up
                continue
            r.t_done = now
            self.done_frames += r.length
            r.eligible = self.window_open
            self._keep_or_drop(r)

    def _keep_or_drop(self, r: _Req) -> None:
        if not r.eligible:
            self.sys.drop_outputs(r.sess)
            return
        r.kept = self.marked(r.i)
        if self.longest is None or r.length > self.longest.length:
            old, self.longest = self.longest, r
            if old is not None and not old.kept:
                self.sys.drop_outputs(old.sess)
        elif not r.kept:
            self.sys.drop_outputs(r.sess)

    def committed(self) -> int:
        return self.done_frames + self.sys.active_frames()

    def sample(self, n_max: int, seed: int) -> List[dict]:
        """Up to ``n_max`` of the kept requests, drawn from the seed, and
        the longest one, with their frames and outputs."""
        kept = [r for r in self.reqs
                if r.kept and r.t_done is not None and r is not self.longest]
        rng = gen.rng_for(seed, 'pick')
        pick = [kept[j] for j in sorted(rng.permutation(len(kept))[:n_max])]
        pick += [self.longest] if self.longest is not None else []
        out = []
        for r in pick:
            off = self.traffic.offset(r.i)
            out.append(dict(i=r.i, length=r.length,
                            frames=self.pool[off:off + r.length],
                            lp=self.sys.outputs(r.sess)))
        return out


def drive(system, traffic: gen.Traffic, pool: torch.Tensor, cell: dict,
          seconds: float, tracer, t_proc: float, seed: int) -> dict:
    run = _Run(system, traffic, pool.cpu().numpy(), cell['sample']['share'],
               seed)
    clock = time.perf_counter
    depth = cell['queue_depth']

    def top_up():
        while system.pending < depth:
            run.submit()

    t_w = clock()
    while clock() - t_w < cell['warmup_s']:
        top_up()
        run.step()
    t0 = clock()
    f0 = run.committed()
    run.window_open = True
    while clock() - t0 < seconds:
        top_up()
        run.step()
    t1 = clock()
    frames = run.committed() - f0
    run.window_open = False
    trace = None
    if tracer is not None:
        system.calls = []
        tracer.start()
        while tracer.elapsed() < cell['trace_s']:
            top_up()
            run.step()
        summary = tracer.stop()
        trace = (summary, Traced(calls=[(T, B, int(valid.sum()))
                                        for T, B, valid in system.calls]))
        system.calls = None
    done = [r for r in run.reqs if r.eligible]
    return dict(setup_s=t0 - t_proc, window_s=t1 - t0, frames=frames,
                attempted=len(done),
                failed=sum(1 for r in done if r.sess.error is not None),
                trace=trace, sample=run.sample(cell['sample']['max'], seed))
