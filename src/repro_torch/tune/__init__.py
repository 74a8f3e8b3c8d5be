"""Measured-schedule autotuning for the port's dispatch (DESIGN.md §12,
§13).

``schedule``: the persisted JSON cache of dispatch winners and the
process-wide registry that dispatch consults (the reference's format, so
either package loads the other's file).  ``shmoo``: the shared record
format and the staged and geometry candidate spaces.  ``autotune``:
interleaved timed trials (K4 against the K3 chain; K2's layer block; the
serving loop's chunk depth; the staged scale-out's chunk depth on a mesh
and its geometry inside an engine budget) and the replay check.  ``python -m
repro_torch.tune`` runs the offline tuner.
"""
from .autotune import (measure_interleaved, quantized_trial,
                       reference_geometry, replay_check, serving_depths,
                       tune_geometry, tune_quantized_backend,
                       tune_serving_config, tune_stack_lb,
                       tune_staged_stack)
from .schedule import (ANY_MESH, ScheduleCache, ScheduleEntry,
                       clear_schedule_cache, current_schedule_cache,
                       devices_signature, host_fingerprint,
                       install_schedule_cache, mesh_signature,
                       using_schedule_cache)
from .shmoo import (TC_GRID, GeometryCandidate, ShmooRecord, StagedCandidate,
                    card_budget, enumerate_geometry_candidates,
                    enumerate_lb_candidates, enumerate_staged_candidates,
                    geometry_shmoo_records, rank_geometry_candidates,
                    rank_lb_candidates, rank_staged_candidates,
                    staged_shmoo_records, write_shmoo_csv)

__all__ = [
    'ANY_MESH', 'GeometryCandidate', 'ScheduleCache', 'ScheduleEntry',
    'ShmooRecord', 'StagedCandidate', 'TC_GRID', 'card_budget',
    'clear_schedule_cache', 'current_schedule_cache', 'devices_signature',
    'enumerate_geometry_candidates', 'enumerate_lb_candidates',
    'enumerate_staged_candidates',
    'geometry_shmoo_records', 'host_fingerprint', 'install_schedule_cache',
    'measure_interleaved', 'mesh_signature', 'quantized_trial',
    'rank_geometry_candidates', 'rank_lb_candidates',
    'rank_staged_candidates',
    'reference_geometry', 'replay_check', 'serving_depths',
    'staged_shmoo_records', 'tune_geometry', 'tune_quantized_backend',
    'tune_serving_config', 'tune_stack_lb', 'tune_staged_stack',
    'using_schedule_cache',
    'write_shmoo_csv',
]
