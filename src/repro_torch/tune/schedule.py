"""Measured-schedule cache: persisted winners for dispatch decisions.

Port of ``repro.tune.schedule`` (DESIGN.md §12).  The port's dispatch
(``core.lstm.select_quantized_stack_backend``, ``core.lstm
.resolve_serving_backend``'s ``auto``, ``serving.engine
.tuned_chunk_ceiling``) consults the installed cache first and falls back
to its cold-cache rules on a miss.  ``repro_torch.tune.autotune`` fills
the cache offline, from interleaved timed trials on the card; serving
never measures at request time.

Contract, as in the reference:

* **Dispatch-only.** A hit may change which schedule runs (K4 or the K3
  chain, K2 or K1, the chunk-depth ceiling), never the numerics: every
  schedule an entry can select is bit-identical to the fallback's.
* **Deterministic replay.** ``to_json`` is canonical (entries sorted by
  key, keys sorted), so ``load(save(c))`` is byte for byte ``c``, and the
  reference's JSON loads here unchanged (every field of ``ScheduleEntry``
  is kept, the staged and geometry ones too).
* **Keyed by shape and placement.** ``(kind, n_x, n_h, n_layers, T, B,
  mesh)``; ``T=0`` / ``B=0`` are wildcards and ``mesh='any'`` matches
  every placement.  Lookups under an installed systolic mesh use its
  signature (``mesh_signature``), else ``'any'``.
* **Provenance, not key.** ``host`` names the machine and device a
  measured entry came from; a cache is valid dispatch anywhere.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import platform as _platform
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Tuple

import torch

#: Decision families the cache can answer.  ``stack_f32`` / ``stack_int8``
#: carry the staged scale-out schedule (``tc``, ``in_stage``, and — since
#: the geometry tuner — an optional uneven per-stage ``blocks`` split);
#: ``stack_backend`` / ``q_stack_backend`` carry a backend name;
#: ``geometry`` carries a full mesh geometry winner (``stages`` x ``rows``
#: x ``cols`` + ``blocks``) keyed by the DEVICE BUDGET signature
#: ``'devices:N'`` rather than a concrete mesh (the decision is "which
#: mesh to build", so it cannot be keyed by the mesh it produces);
#: ``serving_chunk`` carries the measured end-to-end serving-loop chunk
#: ceiling (``tc``); ``stack_lb`` carries the §8 single-engine
#: layer-block streaming factor (``lb``).  The port's tuner writes
#: ``q_stack_backend``, ``serving_chunk``, ``stack_f32`` and ``geometry``;
#: the staged scale-out reads the ``tc`` and ``blocks`` of ``stack_f32`` /
#: ``stack_int8`` entries (``core.systolic.resolve_staged_chunk`` /
#: ``_blocks``) and not their ``in_stage``, since it runs one in-stage
#: order (``'sequential'``, which the port's entries record); the ``lb``
#: kind loads and round-trips.
KINDS = ('stack_f32', 'stack_int8', 'stack_backend', 'q_stack_backend',
         'geometry', 'serving_chunk', 'stack_lb')


def devices_signature(n_devices: int) -> str:
    """Cache-key signature for a DEVICE-BUDGET-keyed decision (kind
    ``'geometry'``): the tuner answers "best mesh for N devices", so the
    key carries the budget, not any one mesh built from it."""
    return f'devices:{int(n_devices)}'

#: Wildcard mesh signature: matches any placement (including none).
ANY_MESH = 'any'


def mesh_signature(mesh) -> str:
    """Canonical placement signature for cache keys: ``None`` -> ``'any'``
    (one engine, no scale-out); a mesh (``core.systolic.SystolicMesh``, or
    anything with a ``shape`` dict) -> its axis sizes in axis order, e.g.
    ``'stage:3,row:5,col:5'``, the reference's string; a string passes
    through unchanged; anything else raises ``TypeError``."""
    if mesh is None:
        return ANY_MESH
    if isinstance(mesh, str):
        return mesh
    shape = getattr(mesh, 'shape', None)
    if not isinstance(shape, dict):
        raise TypeError(f'mesh signature of {type(mesh).__name__}: takes '
                        f'None, a signature string or a mesh')
    return ','.join(f'{name}:{dim}' for name, dim in shape.items())


def host_fingerprint(device=None) -> str:
    """Provenance stamp for measured entries (NOT part of the cache key):
    ``'<machine>/cudax<cards>'`` for a trial on a CUDA ``device``,
    ``'<machine>/cpux1'`` on the CPU; ``device=None`` means CUDA where a
    card is present."""
    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == 'cuda')
    count = torch.cuda.device_count() if cuda else 1
    return f'{_platform.machine()}/{"cuda" if cuda else "cpu"}x{count}'


@dataclasses.dataclass
class ScheduleEntry:
    """One measured (or predicted) dispatch winner.

    Key fields: ``kind`` + the shape/placement tuple.  Decision fields —
    only the ones meaningful for the kind are non-default: ``tc`` /
    ``in_stage`` / ``blocks`` for the staged schedule kinds, ``backend``
    for the backend-choice kinds, ``stages``/``rows``/``cols``/``blocks``
    for ``geometry``, ``lb`` for ``stack_lb``, ``tc`` for
    ``serving_chunk``.  ``predicted_us`` / ``measured_us`` record the
    ranking evidence; ``source`` is ``'measured'`` when a timed trial
    decided, ``'predicted'`` when only the model ranking did.
    """
    kind: str
    n_x: int = 0
    n_h: int = 0
    n_layers: int = 0
    T: int = 0            # 0 = wildcard (any sequence length)
    B: int = 0            # 0 = wildcard (any batch)
    mesh: str = ANY_MESH
    tc: int = 0
    in_stage: str = ''
    backend: str = ''
    bn: int = 0
    bk: int = 0
    lb: int = 0
    stages: int = 0       # geometry winner: live stage count (0 = n/a)
    rows: int = 0         # geometry winner: engine-grid rows (0 = n/a)
    cols: int = 0         # geometry winner: engine-grid cols (0 = n/a)
    blocks: str = ''      # per-stage layer counts, e.g. '2,1' ('' = balanced)
    predicted_us: float = 0.0
    measured_us: float = 0.0
    source: str = 'predicted'
    host: str = ''

    def __post_init__(self):
        assert self.kind in KINDS, (self.kind, KINDS)

    def key(self) -> Tuple:
        return (self.kind, int(self.n_x), int(self.n_h), int(self.n_layers),
                int(self.T), int(self.B), self.mesh)


class ScheduleCache:
    """In-memory map of ``ScheduleEntry`` winners with wildcard lookup."""

    def __init__(self, entries: Iterable[ScheduleEntry] = ()):
        self._entries: Dict[Tuple, ScheduleEntry] = {}
        for e in entries:
            self.record(e)

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> List[ScheduleEntry]:
        return [self._entries[k] for k in sorted(self._entries)]

    def record(self, entry: ScheduleEntry) -> None:
        """Insert/replace the winner for ``entry.key()``."""
        self._entries[entry.key()] = entry

    def lookup(self, kind: str, *, n_x: int, n_h: int, n_layers: int,
               T: int, B: int, mesh: str = ANY_MESH
               ) -> Optional[ScheduleEntry]:
        """Most-specific matching entry, or None.

        Precedence: for each placement (the query's mesh signature first,
        then the ``'any'`` wildcard), try ``(T, B)`` exact, then ``T``
        exact / ``B`` wildcard, then ``T`` wildcard / ``B`` exact, then
        both wildcards.  A specific measurement therefore always shadows a
        family-wide one.
        """
        meshes = (mesh, ANY_MESH) if mesh != ANY_MESH else (ANY_MESH,)
        for m in meshes:
            for t, b in ((T, B), (T, 0), (0, B), (0, 0)):
                ent = self._entries.get(
                    (kind, int(n_x), int(n_h), int(n_layers), t, b, m))
                if ent is not None:
                    return ent
        return None

    # ------------------------------------------------------- persistence
    def to_json(self) -> str:
        """Canonical JSON: entries sorted by key, keys sorted — so equal
        caches serialise byte-identically (the replay-determinism pin)."""
        return json.dumps(
            {'version': 1,
             'entries': [dataclasses.asdict(e) for e in self.entries()]},
            indent=2, sort_keys=True) + '\n'

    def save(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.write_text(self.to_json())
        return path

    @classmethod
    def from_json(cls, text: str) -> 'ScheduleCache':
        doc = json.loads(text)
        assert doc.get('version') == 1, doc.get('version')
        return cls(ScheduleEntry(**e) for e in doc['entries'])

    @classmethod
    def load(cls, path) -> 'ScheduleCache':
        return cls.from_json(pathlib.Path(path).read_text())


# ---------------------------------------------------------------------------
# Process-wide registry (what dispatch consults)
# ---------------------------------------------------------------------------
_CURRENT: Optional[ScheduleCache] = None


def install_schedule_cache(cache) -> ScheduleCache:
    """Install ``cache`` (a ``ScheduleCache`` or a JSON path) as the cache
    dispatch consults.  Returns the installed object."""
    global _CURRENT
    if not isinstance(cache, ScheduleCache):
        cache = ScheduleCache.load(cache)
    _CURRENT = cache
    return cache


def current_schedule_cache() -> Optional[ScheduleCache]:
    """The installed cache, or None (dispatch then uses estimation rules)."""
    return _CURRENT


def clear_schedule_cache() -> None:
    """Uninstall the process-wide schedule cache: every consumer falls back
    to its hand-derived cold-cache default on the next lookup."""
    global _CURRENT
    _CURRENT = None


@contextmanager
def using_schedule_cache(cache):
    """Scoped install (tests): installs ``cache``, restores the previous
    cache on exit."""
    global _CURRENT
    prev = _CURRENT
    try:
        yield install_schedule_cache(cache)
    finally:
        _CURRENT = prev
