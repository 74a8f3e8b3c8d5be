"""Architecture and shape configuration for the ported LSTM family.

The subset of ``repro.configs.ArchConfig`` that the paper's CTC LSTM uses
(name, family, layer count, widths, parameter dtype, backend, optimizer),
``ShapeConfig`` (a batch's sequence length and size), and the registry
lookups ``get_config`` / ``get_smoke_config``.  The backend names are the
port's (``core.lstm.BACKENDS``), not the TPU ones.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # only 'lstm' is ported
    n_layers: int
    lstm_hidden: int
    lstm_inputs: int
    n_outputs: int
    param_dtype: str = 'float32'
    # auto | torch_scan | cuda_seq | cuda_seq_fused | cuda_step
    # (core.lstm.BACKENDS)
    lstm_backend: str = 'auto'
    optimizer: str = 'adamw'       # optim.make_optimizer; only adamw ported

    def dtype(self) -> torch.dtype:
        """The parameter / state dtype as a torch dtype."""
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> 'ArchConfig':
        """A copy with the given fields replaced (the config is frozen)."""
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One batch shape: ``kind`` is ``train`` here; ``seq_len`` frames per
    utterance, ``global_batch`` utterances per step."""
    name: str
    kind: str
    seq_len: int
    global_batch: int


ARCH_MODULES = {'chipmunk-ctc': 'chipmunk_ctc'}


def get_config(name: str) -> ArchConfig:
    """The full configuration of architecture ``name``."""
    return importlib.import_module(f'.{ARCH_MODULES[name]}', __package__).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    """The reduced same-family configuration of ``name`` for CPU tests."""
    return importlib.import_module(f'.{ARCH_MODULES[name]}', __package__).SMOKE
