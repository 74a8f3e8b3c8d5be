"""The traffic generator: deterministic in the seed, true to its file's
parameters, and the same set of sizes under every seed."""
import json

import numpy as np
import pytest

from bench import gen

SEEDS = (0, 7, 2 ** 31 + 11)


def test_lengths_follow_the_file():
    spec = gen.load('librispeech.offline')
    ln = spec['lengths']
    t = gen.Traffic(spec, 3, 1 << 20)
    lens = np.array([t.length(i) for i in range(ln['block'])])
    assert lens.min() >= ln['min'] and lens.max() <= ln['max']
    assert abs(np.median(lens) - ln['median']) <= 1
    got_sigma = np.std(np.log(lens[(lens > ln['min']) & (lens < ln['max'])]))
    assert abs(got_sigma - ln['sigma']) < 0.05
    assert sorted(lens) == sorted(gen.length_block(spec, ln['block']))


@pytest.mark.parametrize('seed', SEEDS)
def test_deterministic_in_the_seed(seed):
    spec = gen.load('librispeech.offline')
    a = gen.Traffic(spec, seed, 1 << 20)
    b = gen.Traffic(spec, seed, 1 << 20)
    for i in (0, 1, 4095, 4096, 9000):
        assert (a.length(i), a.offset(i)) == (b.length(i), b.offset(i))
        assert 0 <= a.offset(i) <= (1 << 20) - a.length(i)


def test_seeds_reorder_the_same_work():
    spec = gen.load('librispeech.offline')
    ts = [gen.Traffic(spec, s, 1 << 20) for s in SEEDS]
    n = spec['lengths']['block']
    sets = [sorted(t.length(i) for i in range(n)) for t in ts]
    assert sets[0] == sets[1] == sets[2]
    orders = [[t.length(i) for i in range(n)] for t in ts]
    assert orders[0] != orders[1]
    offsets = [[t.offset(i) for i in range(8)] for t in ts]
    assert offsets[0] != offsets[1]


@pytest.mark.parametrize('bad', [{'arrival': 'poisson'},
                                 {'lengths': {'dist': 'uniform'}}],
                         ids=['arrival', 'lengths'])
def test_unknown_mix_is_refused(tmp_path, monkeypatch, bad):
    spec = dict(gen.load('librispeech.offline'), **bad)
    (tmp_path / 'x.json').write_text(json.dumps(spec))
    monkeypatch.setattr(gen, 'TRAFFIC_DIR', tmp_path)
    with pytest.raises(ValueError):
        gen.load('x')


def test_pooled_batches():
    spec = gen.load('librispeech.offline')
    t = gen.Traffic(spec, 5, 1 << 20, batch=16)
    it = t.batches()
    pool = [next(it) for _ in range(spec['pool_batches'])]
    rows = np.concatenate([r for r, _ in pool])
    assert sorted(rows) == list(range(16 * spec['pool_batches']))
    for r, T in pool:
        assert T == max(t.length(int(i)) for i in r)
    nxt = [next(it) for _ in range(spec['pool_batches'])]
    assert sorted(T for _, T in nxt) == sorted(T for _, T in pool)
    with pytest.raises(ValueError):
        next(gen.Traffic(spec, 5, 1 << 20).batches())
