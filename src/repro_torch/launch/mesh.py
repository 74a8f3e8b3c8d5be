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
"""
from __future__ import annotations

from ..core.systolic import SystolicMesh, install_mesh, make_systolic_mesh

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
