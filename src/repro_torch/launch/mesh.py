"""Systolic topology presets (DESIGN.md §6 and §9).

Port of the systolic half of ``repro.launch.mesh``: the paper's engine
grids as named ``(stage, rows, cols)`` presets, built into a
``core.systolic.SystolicMesh`` and installed as the process mesh that
``core.lstm``'s ``auto`` dispatch consults.  Stage-1 presets drive the
layerwise scale-out (``cuda_seq_systolic``), stage > 1 presets the staged
one (``cuda_seq_fused_systolic``).  ``graves-75`` is the 75-tile 3x(5x5)
configuration that runs the Graves phoneme topology in real time (paper
Sec. 4.2, Table 2)::

    python -m repro_torch.launch.serve --systolic-topology graves-75

Every engine of a preset sits on one device unless ``devices`` lists
them; one process drives them all.

The two-level die hierarchy (DESIGN.md §14): a ``DieMesh`` is a fleet of
``dies`` fault domains, each holding ``stage`` pipeline stages of
``rows x cols`` engines.  A die failure removes exactly its engines, and
the systolic array re-forms on the surviving dies (``submesh``): the
serving engine's recovery runtime then steps onto a real intermediate rung
(``graves-3x25``: 75 -> 50 -> 25 engines) instead of a flat kernel::

    python -m repro_torch.launch.serve --die-topology graves-3x25

The production mesh of the reference's dry run (``make_production_mesh``):
a ``torch.distributed`` ``DeviceMesh`` of ('data', 'model') = (16, 16) or
('pod', 'data', 'model') = (2, 16, 16), over the fake process-group
backend when no group exists (every collective completes at once and
moves nothing; ``launch.dryrun`` runs the real step on it under fake
tensors).  ``resolve_rules`` drops the mesh axes a mesh lacks.  The
card's peak rates, which the roofline and ``chip_smoke.py``'s bounds
read, are defined here once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Dict, Optional, Sequence, Tuple

import torch

from ..core.systolic import (SystolicMesh, _device, install_mesh,
                             make_systolic_mesh)

# ---------------------------------------------------------------------------
# The card: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates without
# sparsity, at the full 700 W power limit)
# ---------------------------------------------------------------------------
HBM_BW = 3.35e12              # B/s, HBM3 (80 GB)
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16/fp16 tensor cores
PEAK_FLOPS_TF32 = 495e12      # FLOP/s, TF32 tensor cores
PEAK_FLOPS_F32 = 67e12        # FLOP/s, f32 outside the tensor cores
PEAK_OPS_INT8 = 1979e12       # OP/s, int8 tensor cores
LINK_BW = 450e9               # B/s a direction, NVLink 4 (900 GB/s total)
HBM_BYTES = 80e9              # device memory a card
SMS = 132                     # streaming multiprocessors (a launch's geometry)


def peak_rate(dtype: torch.dtype) -> float:
    """The card's peak arithmetic rate for operands of ``dtype``: the
    tensor cores' for bf16/fp16 and int8, f32's outside the tensor cores
    for everything else (the port keeps TF32 off, as the reference's f32
    is)."""
    if dtype in (torch.bfloat16, torch.float16):
        return PEAK_FLOPS_BF16
    if dtype in (torch.int8, torch.uint8):
        return PEAK_OPS_INT8
    return PEAK_FLOPS_F32


# ---------------------------------------------------------------------------
# The production mesh
# ---------------------------------------------------------------------------
def _init_fake_group(world_size: int) -> None:
    """A process group of ``world_size`` ranks over PyTorch's fake backend
    (this process is rank 0; collectives complete at once)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group('fake', store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False):
    """The (data, model) mesh of the reference's launch scripts: one 16x16
    pod slice, or two pods under a leading 'pod' axis, as a CPU
    ``DeviceMesh``.  Built over the fake backend when no process group
    exists; a group of another size raises (a process holds one group, so
    a dry run runs in its own process)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ('pod', 'data', 'model') if multi_pod else ('data', 'model')
    n = math.prod(shape)
    if not dist.is_initialized():
        _init_fake_group(n)
    elif dist.get_world_size() != n:
        raise RuntimeError(f'make_production_mesh: a process group of '
                           f'{dist.get_world_size()} ranks exists, the mesh '
                           f'needs {n}')
    return init_device_mesh('cpu', shape, mesh_dim_names=axes)


def resolve_rules(rules: Dict[str, object], mesh) -> Dict[str, object]:
    """Drop mesh axes that don't exist on this mesh (e.g. 'pod' on a
    single pod)."""
    names = set(getattr(mesh, "mesh_dim_names", None) or mesh.axis_names)
    out = {}
    for k, v in rules.items():
        if v is None:
            out[k] = None
        elif isinstance(v, str):
            out[k] = v if v in names else None
        else:
            kept = tuple(a for a in v if a in names)
            out[k] = kept if kept else None
    return out


# name -> (stage, rows, cols) engine grids from the paper's scaling study.
SYSTOLIC_TOPOLOGIES = {
    # degenerate single-engine preset: never auto-picked (an all-1 mesh is
    # inadmissible, §6.2) — use with an explicit backend
    'single': (1, 1, 1),
    '1x2': (1, 1, 2),        # smallest col (partial-sum hop) scale-out
    '2x1': (1, 2, 1),        # smallest row (h re-broadcast) scale-out
    '2x2': (1, 2, 2),
    '5x5': (1, 5, 5),        # the paper's single-layer 25-tile config
    '5x7': (1, 5, 7),        # CTC-3L-421H layer plan at tile 96 (35 engines)
    'graves-75': (3, 5, 5),  # 3-stage pipeline of 5x5 grids = 75 tiles
}


def make_systolic_topology(name: str, devices=None) -> SystolicMesh:
    """The named preset as a (stage, row, col) mesh; ``devices`` as in
    ``core.systolic.make_systolic_mesh`` (None: every engine on
    ``cuda``)."""
    stage, rows, cols = SYSTOLIC_TOPOLOGIES[name]
    return make_systolic_mesh(rows, cols, stage=stage, devices=devices)


def install_systolic_topology(name: str, devices=None) -> SystolicMesh:
    """Build the named preset and install it as the process systolic mesh.
    After installation ``auto`` resolves to ``cuda_seq_systolic`` for
    layers a stage-1 mesh admits and to ``cuda_seq_fused_systolic`` for
    stacks a stage > 1 mesh admits; an inadmissible preset (the all-1
    ``single``) is installed but never picked by ``auto``."""
    return install_mesh(make_systolic_topology(name, devices))


# ---------------------------------------------------------------------------
# Two-level die/engine fault-domain hierarchy (DESIGN.md §14)
# ---------------------------------------------------------------------------
# The Chipmunk follow-up ("Vau da Muntanialas", PAPERS.md) scales the same
# systolic idea across DIES: the die axis is the fault-domain axis.
# Execution flattens the healthy dies onto the (stage, row, col) staged
# path (total stages = healthy dies x stage), so every degraded rung keeps
# the per-stage (rows x cols) grid and its (bn, bk) blocks.

@dataclasses.dataclass(frozen=True)
class DieMeshView:
    """The explicit 4-axis ('die', 'stage', 'row', 'col') view of a
    ``DieMesh``: what the die-aware admission rule
    (``core.systolic.seq_scaleout_admissible``, which folds ``die`` into
    the pipeline depth) and the per-engine budget (``engine_budget``, over
    ``devices``) read.  No execution runs on it."""
    dies: int
    stage: int
    rows: int
    cols: int
    devices: Tuple[torch.device, ...]

    axis_names: ClassVar[Tuple[str, ...]] = ('die', 'stage', 'row', 'col')

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes in axis order, like ``SystolicMesh.shape``."""
        return {'die': self.dies, 'stage': self.stage, 'row': self.rows,
                'col': self.cols}


@dataclasses.dataclass(frozen=True)
class DieMesh:
    """Two-level ('die', 'stage', 'row', 'col') fleet: ``dies`` fault
    domains, each holding ``stage`` pipeline stages of ``rows x cols``
    engines.  ``devices`` is die-major (one die's engines are contiguous,
    so a die failure maps to one contiguous range), each engine a
    ``torch.device``.  Topology bookkeeping only: execution goes through
    ``submesh``."""
    dies: int
    stage: int
    rows: int
    cols: int
    devices: Tuple[torch.device, ...] = ()

    @property
    def engines_per_die(self) -> int:
        """Engines one die contributes (= engines lost when it fails)."""
        return self.stage * self.rows * self.cols

    @property
    def n_engines(self) -> int:
        """Total engines across all dies."""
        return self.dies * self.engines_per_die

    def die_devices(self, die: int) -> Tuple[torch.device, ...]:
        """The contiguous engine devices of fault domain ``die``."""
        k = self.engines_per_die
        return tuple(self.devices[die * k:(die + 1) * k])

    def submesh(self, healthy: Sequence[int]) -> SystolicMesh:
        """The healthy dies flattened onto one (stage, row, col) execution
        mesh: ``len(healthy) * stage`` stages of the same ``rows x cols``
        grid, the dies in ascending order.  Raises ``ValueError`` on an
        empty or out-of-range die list."""
        healthy = sorted(int(d) for d in healthy)
        if not healthy or not all(0 <= d < self.dies for d in healthy):
            raise ValueError(f'healthy dies {healthy} are not a non-empty '
                             f'subset of range({self.dies})')
        devs = [d for die in healthy for d in self.die_devices(die)]
        return make_systolic_mesh(self.rows, self.cols,
                                  stage=len(healthy) * self.stage,
                                  devices=devs)

    def full_mesh(self) -> DieMeshView:
        """The 4-axis view over every engine (the fault-domain boundary
        explicit); execution uses ``submesh``."""
        return DieMeshView(self.dies, self.stage, self.rows, self.cols,
                           self.devices)


# name -> (dies, stage-per-die, rows, cols).  'graves-3x25' is the paper's
# 75-engine Table-2 topology as THREE 25-engine dies: the ladder then has
# real intermediate rungs (75 -> 50 -> 25 engines).
DIE_TOPOLOGIES = {
    'die-2x1x1': (2, 1, 1, 1),   # 2 dies of one engine each
    'die-3x1x1': (3, 1, 1, 1),   # 3 dies of one engine each
    'die-2x1x2': (2, 1, 1, 2),   # 2 dies of a 1x2 grid
    'graves-3x25': (3, 1, 5, 5),  # 3 dies of 5x5 = the Table-2 75 engines
}

_INSTALLED_DIE_MESH: Optional[DieMesh] = None


def make_die_topology(name: str, devices=None) -> DieMesh:
    """The named ``DIE_TOPOLOGIES`` preset as a ``DieMesh``.  ``devices``:
    None puts every engine on ``cuda``, one device (or its name) puts them
    all there, a sequence places the first ``dies * stage * rows * cols``
    die-major; a shorter sequence raises ``ValueError``."""
    dies, stage, rows, cols = DIE_TOPOLOGIES[name]
    need = dies * stage * rows * cols
    if devices is None or isinstance(devices, (str, torch.device)):
        devs = (_device('cuda' if devices is None else devices),) * need
    else:
        devs = tuple(_device(d) for d in devices)
        if len(devs) < need:
            raise ValueError(f'die topology {name!r} needs {need} devices, '
                             f'have {len(devs)}')
    return DieMesh(dies, stage, rows, cols, devs[:need])


def install_die_topology(name: str, devices=None) -> DieMesh:
    """Build the named preset, register it as the process die mesh, and
    install its all-dies-healthy ``submesh`` as the systolic mesh.  A
    serving engine built after this sees the dies as fault domains: an
    ``EngineFailure`` carrying a die id re-forms the mesh on the surviving
    dies (one rung down), and a healed die comes back through the
    canary-validated promotion.  Dispatch and placement only."""
    global _INSTALLED_DIE_MESH
    dm = make_die_topology(name, devices)
    _INSTALLED_DIE_MESH = dm
    install_mesh(dm.submesh(range(dm.dies)))
    return dm


def current_die_mesh() -> Optional[DieMesh]:
    """The registered die mesh, or None (flat ladders)."""
    return _INSTALLED_DIE_MESH


def clear_die_mesh() -> None:
    """Unregister the die mesh (``core.systolic.clear_mesh`` clears the
    execution mesh)."""
    global _INSTALLED_DIE_MESH
    _INSTALLED_DIE_MESH = None
