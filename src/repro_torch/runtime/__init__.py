"""Host-side serving runtime: the engine's event log (``fault``) and its
deadline-aware chunk sizing (``serving_faults``)."""
from .fault import RingLog
from .serving_faults import ChunkSizePolicy, chunk_deadline_s

__all__ = ['RingLog', 'ChunkSizePolicy', 'chunk_deadline_s']
