"""Measured-schedule autotuning for the port's dispatch (DESIGN.md §12),
on one card.

``schedule``: the persisted JSON cache of dispatch winners and the
process-wide registry that dispatch consults (the reference's format, so
either package loads the other's file).  ``shmoo``: the shared record
format.  ``autotune``: interleaved timed trials (K4 against the K3 chain;
the serving loop's chunk depth) and the replay check.  ``python -m
repro_torch.tune`` runs the offline tuner.
"""
from .autotune import (measure_interleaved, quantized_trial, replay_check,
                       serving_depths, tune_quantized_backend,
                       tune_serving_config)
from .schedule import (ANY_MESH, ScheduleCache, ScheduleEntry,
                       clear_schedule_cache, current_schedule_cache,
                       host_fingerprint, install_schedule_cache,
                       mesh_signature, using_schedule_cache)
from .shmoo import TC_GRID, ShmooRecord, write_shmoo_csv

__all__ = [
    'ANY_MESH', 'ScheduleCache', 'ScheduleEntry', 'ShmooRecord', 'TC_GRID',
    'clear_schedule_cache', 'current_schedule_cache', 'host_fingerprint',
    'install_schedule_cache', 'measure_interleaved', 'mesh_signature',
    'quantized_trial', 'replay_check', 'serving_depths',
    'tune_quantized_backend', 'tune_serving_config', 'using_schedule_cache',
    'write_shmoo_csv',
]
