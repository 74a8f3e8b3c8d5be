"""Shmoo records: the one record format of every schedule sweep.

Port of the record half of ``repro.tune.shmoo``: a ``ShmooRecord`` is
``(suite, params, metrics)`` and ``write_shmoo_csv`` emits the reference's
canonical CSV (``suite`` column, then the param columns, then the metric
columns), so a port sweep and a reference sweep read alike.

Not ported yet, and why: the staged and geometry candidate spaces
(reference :80-340) size a per-device budget for the multi-device staged
forward, which the port does not have until its scale-out (ROADMAP queue 1
item 6); the ``lb`` space (:342-374) streams layer groups through a TPU's
VMEM, while the port's K2 keeps the whole stack resident across the SMs,
so it has no ``lb`` to tune.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, Optional, Sequence

#: Chunk-depth grid of the schedule shmoos (clamped to the chunk).
TC_GRID = (4, 8, 16, 32, 64)


@dataclasses.dataclass
class ShmooRecord:
    """One shmoo point: which sweep, where in the space, what it scored."""
    suite: str
    params: Dict[str, object]
    metrics: Dict[str, float]


def write_shmoo_csv(path, records: Sequence[ShmooRecord],
                    param_order: Optional[Sequence[str]] = None,
                    metric_order: Optional[Sequence[str]] = None
                    ) -> pathlib.Path:
    """Write the shared CSV: ``suite,<params...>,<metrics...>``.

    Column order defaults to the sorted keys of the first record (explicit
    orders let a sweep keep a stable, documented header).  Every record
    must cover the same columns — drift between shmoo producers is a
    ValueError here, not a silently ragged file.
    """
    if not records:
        raise ValueError('empty shmoo')
    pcols = list(param_order or sorted(records[0].params))
    mcols = list(metric_order or sorted(records[0].metrics))
    lines = [','.join(['suite'] + pcols + mcols)]
    for r in records:
        if set(r.params) != set(pcols) or set(r.metrics) != set(mcols):
            raise ValueError(
                f'ragged shmoo record for suite {r.suite!r}: '
                f'{sorted(r.params)}/{sorted(r.metrics)} vs {pcols}/{mcols}')
        vals = ([r.suite] + [_fmt(r.params[c]) for c in pcols]
                + [_fmt(r.metrics[c]) for c in mcols])
        lines.append(','.join(vals))
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text('\n'.join(lines) + '\n')
    return path


def _fmt(v) -> str:
    if isinstance(v, float):
        return f'{v:.4f}'
    return str(v)
