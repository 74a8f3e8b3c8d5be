"""The one traffic generator: reads a mix's parameters from
``bench/traffic/<name>.json`` and draws its requests from the run's seed.

A mix gives ``arrival`` (``closed``: every request is due at t = 0, a
backlog that outlasts the window) and ``lengths`` (``lognormal`` with
``median``, ``sigma``, clipped to ``[min, max]`` frames).  Lengths come in
blocks of ``block`` stratified draws (the distribution's quantiles at
(k + 1/2) / block), each block in its own seeded order, so that every seed
runs the same set of sizes and only their order (and the frames) move
with the seed.  A request's frames are a window of a seeded pool of
input frames, at an offset drawn from the seed.  For a batch loop, the mix
is grouped in pools of ``pool_batches`` batches, each pool sorted by
length and cut into batches, the batches of a pool in seeded order.
"""
from __future__ import annotations

import json
import math
import pathlib
import statistics
from typing import Iterator, List, Tuple

import numpy as np

TRAFFIC_DIR = pathlib.Path(__file__).resolve().parent / 'traffic'
ARRIVALS = ('closed',)


def load(name: str) -> dict:
    """The parameters of mix ``name`` (``bench/traffic/<name>.json``)."""
    spec = json.loads((TRAFFIC_DIR / f'{name}.json').read_text())
    if spec.get('arrival') not in ARRIVALS:
        raise ValueError(f'traffic {name}: arrival must be one of '
                         f'{ARRIVALS}, got {spec.get("arrival")!r}')
    if spec['lengths'].get('dist') != 'lognormal':
        raise ValueError(f'traffic {name}: only lognormal lengths')
    return spec


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent generator for one use (``stream``) of the run's
    seed; any whole number is a seed."""
    key = [int(seed) % 2 ** 64] + [ord(ch) for ch in stream]
    return np.random.default_rng(np.random.SeedSequence(key))


def length_block(spec: dict, block: int) -> np.ndarray:
    """The mix's ``block`` stratified lengths, in ascending order."""
    ln = spec['lengths']
    inv = statistics.NormalDist().inv_cdf
    mu, sigma = math.log(ln['median']), ln['sigma']
    q = [math.exp(mu + sigma * inv((k + 0.5) / block)) for k in range(block)]
    return np.clip(np.rint(q), ln['min'], ln['max']).astype(np.int64)


class Traffic:
    """Requests of one mix under one seed, drawn lazily by index: request
    ``i`` has ``length(i)`` frames at ``offset(i)`` in the frame pool; all
    are due at t = 0.  With ``batch``, the mix comes in pools of
    ``pool_batches`` batches (``batches``): a pool is one block of
    stratified lengths, sorted."""

    def __init__(self, spec: dict, seed: int, pool_frames: int,
                 batch: int = None):
        self.spec = spec
        self.batch = batch
        if batch is not None:
            self.block = batch * int(spec['pool_batches'])
        else:
            self.block = int(spec['lengths'].get('block', 4096))
        self._lengths = length_block(spec, self.block)
        self._order = rng_for(seed, 'order')
        self._offsets = rng_for(seed, 'offsets')
        self.pool_frames = pool_frames
        if int(spec['lengths']['max']) > pool_frames:
            raise ValueError('the frame pool is shorter than the longest '
                             'request')
        self._len: List[np.ndarray] = []
        self._off: List[np.ndarray] = []

    def _grow(self, i: int) -> None:
        while len(self._len) * self.block <= i:
            lens = (self._lengths if self.batch is not None
                    else self._order.permutation(self._lengths))
            self._len.append(lens)
            self._off.append(np.floor(self._offsets.random(self.block)
                                      * (self.pool_frames - lens + 1))
                             .astype(np.int64))

    def length(self, i: int) -> int:
        self._grow(i)
        return int(self._len[i // self.block][i % self.block])

    def offset(self, i: int) -> int:
        self._grow(i)
        return int(self._off[i // self.block][i % self.block])

    def batches(self) -> Iterator[Tuple[np.ndarray, int]]:
        """Endless padded batches: each pool's sorted block cut into
        ``pool_batches`` batches of ``batch``, in seeded order.  Yields
        (request indices (batch,), padded length)."""
        if self.batch is None:
            raise ValueError('a Traffic made without batch has no batches')
        n = int(self.spec['pool_batches'])
        start = 0
        while True:
            for b in self._order.permutation(n):
                lo = start + int(b) * self.batch
                yield (np.arange(lo, lo + self.batch),
                       int(self._lengths[(int(b) + 1) * self.batch - 1]))
            start += self.block
