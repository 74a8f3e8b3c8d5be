"""Host-side runtime of the serving engine and the trainer: the fault
runner and its event log (``fault``), the recovery ladder and health
tracker (``recovery``), and the serving fault model with its deadline-aware
chunk sizing (``serving_faults``)."""
from .fault import FaultConfig, FaultTolerantRunner, RingLog, StepTimer
from .recovery import MeshHealthTracker, Rung, build_rungs
from .serving_faults import (ChunkSizePolicy, EngineFailure,
                             ServingFaultConfig, StreamStateCheckpointer,
                             chunk_deadline_s, elastic_replace, finite_slots)

__all__ = ['FaultConfig', 'FaultTolerantRunner', 'RingLog', 'StepTimer',
           'MeshHealthTracker', 'Rung', 'build_rungs', 'ChunkSizePolicy',
           'EngineFailure', 'ServingFaultConfig', 'StreamStateCheckpointer',
           'chunk_deadline_s', 'elastic_replace', 'finite_slots']
