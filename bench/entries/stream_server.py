"""Entry ``stream_server``: the f32 streaming front end,
``repro_torch.launch.serve.StreamServer`` over its ``StreamingEngine``.

The drive loop submits whole utterances and calls ``engine.step()``
itself, so that it stamps submissions and commits on its own clock.  The
only hook is a wrapper around the engine's packed chunk call, which
records each call's (T, B) and its device tensor of valid counts while a
traced window is open, and applies a planted fault in the tests.  A step
after which the engine no longer calls the wrapper (it replaced its chunk
call, as a backend's degrade does) raises: the counts and the faults
would go unseen.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

FAULTS = ('state_unchanged', 'half_batch', 'answer_altered')


def arch_config(cfg: dict):
    """The program's ``ArchConfig`` for a configuration file: its
    architecture's, at the file's widths, with the file's overrides."""
    from repro_torch.configs import get_config
    return get_config(cfg['arch']).replace(
        lstm_inputs=cfg['n_x'], lstm_hidden=cfg['n_h'], d_model=cfg['n_h'],
        n_layers=cfg['n_layers'], n_outputs=cfg['n_out'],
        vocab_size=cfg['n_out'], **cfg['program'].get('config', {}))


def stack_params(weights: dict):
    """The benchmark's weights as the program's ``LSTMStackParams``."""
    from repro_torch.core.lstm import LSTMParams, LSTMStackParams
    return LSTMStackParams(tuple(LSTMParams(**l) for l in weights['layers']),
                           weights['w_out'], weights['b_out'])


class System:
    """One ``StreamServer`` with ``cell['slots']`` slots and chunks of
    ``cell['chunk']`` frames, on the configuration's pinned backend."""

    def __init__(self, cfg: dict, cell: dict, weights: dict, device):
        from repro_torch.launch.serve import StreamServer
        prog = cfg['program']
        self.server = StreamServer(
            arch_config(cfg), stack_params(weights), num_slots=cell['slots'],
            chunk=cell['chunk'], async_dispatch=prog['async_dispatch'])
        self.engine = self.server.engine
        if (self.engine.device.type == 'cuda'
                and self.engine.backend != prog['config']['lstm_backend']):
            raise RuntimeError(f'the engine resolved {self.engine.backend}, '
                               f'not {prog["config"]["lstm_backend"]}')
        self.calls: Optional[list] = None
        self._fault: Optional[str] = None
        self._n_done = 0
        inner = self.engine._fwd

        def fwd(states, frames, valid):
            if self.calls is not None:
                self.calls.append((frames.shape[1], frames.shape[0], valid))
            lp, new_states, finite = inner(states, frames, valid)
            if self._fault == 'state_unchanged':
                new_states = states
            elif self._fault == 'half_batch':
                lp = lp.clone()
                lp[1::2] = 0
            elif self._fault == 'answer_altered':
                lp = lp.clone()
                lp[0, 0, 0] += 1.0
            return lp, new_states, finite

        self.engine._fwd = self._hook = fwd

    def warm(self, pool) -> None:
        """Build and load the kernels and warm the chunk call's one shape
        (T = chunk, B = slots) before any traffic: a full slot grid of
        two-chunk streams from the pool, drained."""
        frames = pool[:2 * self.engine.chunk].cpu().numpy()
        for _ in range(self.engine.sched.num_slots):
            self.submit(frames)
        self.engine.run()
        self.new_done()

    def inject(self, fault: str) -> None:
        """Break the timed path underneath (tests of the comparison)."""
        if fault not in FAULTS:
            raise ValueError(f'fault one of {FAULTS}, not {fault!r}')
        self._fault = fault

    def submit(self, frames: np.ndarray):
        return self.server.submit(frames)

    def step(self) -> bool:
        stepped = self.engine.step()
        if self.engine._fwd is not self._hook:
            raise RuntimeError('the engine replaced its chunk call '
                               f'(backend now {self.engine.backend}): the '
                               "benchmark's hook no longer sees it")
        return stepped

    def new_done(self) -> List:
        """Sessions retired since the last call, in retirement order."""
        done = self.engine.sched.done
        fresh = done[self._n_done:]
        self._n_done = len(done)
        return fresh

    def active_frames(self) -> int:
        """Frames committed so far by the streams still in slots."""
        return sum(s.cursor for _, s in self.engine.sched.active())

    @property
    def pending(self) -> int:
        return len(self.engine.sched.pending)

    @staticmethod
    def outputs(sess) -> np.ndarray:
        """A retired stream's (L, n_out) log-probs."""
        return sess.full_log_probs()

    @staticmethod
    def drop_outputs(sess) -> None:
        sess.log_probs = []

    def close(self) -> None:
        self.engine._sync()
        self.engine = self.server = None
