"""Entry ``deploy_int8``: the paper's int8 deployment,
``repro_torch.examples.speech_ctc.deploy_int8`` on the layers that
``quantize_layers`` builds from the benchmark's float32 weights.

A call runs a padded batch of whole utterances from zero state through the
quantized stack on the configuration's backend and returns the top
layer's codes and the log-probs, both on the device.
"""
from __future__ import annotations

from typing import Optional

import torch

from .stream_server import stack_params

FAULTS = ('state_unchanged', 'half_batch', 'answer_altered')


class System:
    """``deploy_int8`` with the configuration's pinned backend."""

    def __init__(self, cfg: dict, cell: dict, weights: dict, device):
        from repro_torch.examples.speech_ctc import (deploy_int8,
                                                     quantize_layers)
        self._deploy = deploy_int8
        self.backend = cfg['program']['backend']
        self.params = stack_params(weights)
        self.qps = quantize_layers(self.params)
        self._fault: Optional[str] = None

    def warm(self, pool) -> None:
        """Nothing before the traffic: the loop's first batches build the
        kernels and warm the pool's shapes."""

    def inject(self, fault: str) -> None:
        """Break the timed path underneath (tests of the comparison)."""
        if fault not in FAULTS:
            raise ValueError(f'fault one of {FAULTS}, not {fault!r}')
        self._fault = fault

    def run(self, frames: torch.Tensor):
        """(B, T, n_x) frames -> (codes (T, B, N) int8, log-probs
        (T, B, n_out))."""
        if self._fault == 'state_unchanged':
            B, T, n_x = frames.shape
            codes, lp, _ = self._deploy(self.params,
                                        frames.reshape(B * T, 1, n_x),
                                        self.qps, backend=self.backend)
            return (codes.reshape(B, T, -1).transpose(0, 1),
                    lp.reshape(B, T, -1).transpose(0, 1))
        codes, lp, ran = self._deploy(self.params, frames, self.qps,
                                      backend=self.backend)
        if ran != self.backend:
            raise RuntimeError(f'deploy_int8 ran {ran}, not {self.backend}')
        if self._fault == 'half_batch':
            codes, lp = codes.clone(), lp.clone()
            codes[:, 1::2] = 0
            lp[:, 1::2] = 0
        elif self._fault == 'answer_altered':
            codes = codes.clone()
            codes[0, 0, 0] += 1
        return codes, lp

    def close(self) -> None:
        self.params = self.qps = None
