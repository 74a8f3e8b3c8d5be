from .manager import CheckpointManager

__all__ = ['CheckpointManager']
