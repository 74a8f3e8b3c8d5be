"""Streaming serving of the LSTM family: the packed multi-stream engine,
its slot scheduler and per-stream sessions."""
from .engine import StreamingEngine
from .scheduler import SlotScheduler
from .session import IncrementalCTCDecoder, StreamSession

__all__ = ['StreamingEngine', 'SlotScheduler', 'IncrementalCTCDecoder',
           'StreamSession']
