"""Streaming serving of the LSTM family: the packed multi-stream engine,
its slot scheduler and per-stream sessions, and the deadline policy's
cache-first chunk ceiling."""
from .engine import StreamingEngine, tuned_chunk_ceiling
from .scheduler import SlotScheduler
from .session import IncrementalCTCDecoder, StreamSession

__all__ = ['StreamingEngine', 'SlotScheduler', 'IncrementalCTCDecoder',
           'StreamSession', 'tuned_chunk_ceiling']
