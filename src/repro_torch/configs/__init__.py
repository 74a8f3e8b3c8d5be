"""Architecture and shape configuration registry of the port.

``ArchConfig`` carries the reference's field list (``repro.configs``), so a
configuration file copies across, with these differences for the card: the
backend names are the port's (``lstm_backend`` takes
``core.lstm.BACKENDS``), ``attn_backend`` takes the place of the
reference's ``use_pallas`` switch for attention (``models.layers``), and
the blocking knobs that nothing of the port reads (``scan_layers``, a
Python loop over the stacked layers in its place; ``attn_chunk``, since
K8 takes any length) are left out.  ``remat`` is the reference's
(``models.transformer`` applies it to each layer under grad).
``adtype()``/``dtype()`` return torch dtypes.  ``ARCH_MODULES`` holds
every configuration of the reference: the paper's CTC LSTM, the four dense
LMs, the two MoE LMs (Mixtral 8x22B, Kimi-K2), the two cross-attention LMs
(whisper-base, encoder-decoder; Llama-3.2-Vision-90B, one cross layer in
five) and the two recurrent LMs (xLSTM-1.3B, family ``ssm``: mLSTM and
sLSTM blocks; Hymba-1.5B, family ``hybrid``: attention beside Mamba heads;
``models.recurrent``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    capacity_factor: float = 1.25
    router_dtype: str = 'float32'


ATTN_BACKENDS = ('auto', 'torch')


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm | lstm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    moe: Optional[MoEConfig] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: Optional[int] = None    # SWA width (mixtral, hymba)
    global_layer_ids: Tuple[int, ...] = ()  # full-attn layers in SWA models
    cross_attn_every: Optional[int] = None  # vlm: 1 cross layer per N
    n_source_tokens: int = 0                # audio/vlm stub frontend length
    rope_theta: float = 10_000.0
    norm: str = 'rmsnorm'                   # rmsnorm | layernorm
    act: str = 'silu'                       # silu (SwiGLU) | gelu
    tie_embeddings: bool = False
    # recurrent families
    ssm_state: int = 0                      # mamba state dim (hybrid)
    xlstm_slstm_every: int = 0              # ssm family: 1 sLSTM per N blocks
    conv_kernel: int = 4
    # encoder-decoder (audio)
    n_encoder_layers: int = 0
    # paper-native LSTM family
    lstm_hidden: int = 0
    lstm_inputs: int = 0
    n_outputs: int = 0
    # numerics / execution
    param_dtype: str = 'float32'
    activation_dtype: str = 'bfloat16'
    remat: str = 'full'                     # none | full | dots
    # auto: K8 (kernels.flash_attention) on CUDA tensors, its plain version
    # on CPU ones | torch: the plain version on any device
    attn_backend: str = 'auto'
    # auto | torch_scan | cuda_seq | cuda_seq_fused | cuda_step |
    # cuda_seq_systolic | cuda_seq_fused_systolic (core.lstm.BACKENDS)
    lstm_backend: str = 'auto'
    optimizer: str = 'adamw'                # adamw | adafactor | sgd

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def dtype(self) -> torch.dtype:
        """The parameter / state dtype as a torch dtype."""
        return getattr(torch, self.param_dtype)

    def adtype(self) -> torch.dtype:
        """The activation (and KV cache) dtype as a torch dtype."""
        return getattr(torch, self.activation_dtype)

    def replace(self, **kw) -> 'ArchConfig':
        """A copy with the given fields replaced (the config is frozen)."""
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One batch shape: ``kind`` is ``train``, ``prefill`` or ``decode``;
    ``seq_len`` tokens (frames, for the CTC LSTM) per sequence, or a
    decode's cache length; ``global_batch`` sequences per step."""
    name: str
    kind: str
    seq_len: int
    global_batch: int

    @property
    def is_train(self) -> bool:
        return self.kind == 'train'


# The four assigned LM shapes of the reference's dry run (identical across
# the ten LM architectures; ``shapes_for`` drops ``long_500k`` where the
# attention is quadratic).
SHAPES: Dict[str, ShapeConfig] = {
    'train_4k': ShapeConfig('train_4k', 'train', 4_096, 256),
    'prefill_32k': ShapeConfig('prefill_32k', 'prefill', 32_768, 32),
    'decode_32k': ShapeConfig('decode_32k', 'decode', 32_768, 128),
    'long_500k': ShapeConfig('long_500k', 'decode', 524_288, 1),
}


ARCH_MODULES = {
    'xlstm-1.3b': 'xlstm_1_3b',
    'kimi-k2-1t-a32b': 'kimi_k2_1t_a32b',
    'mixtral-8x22b': 'mixtral_8x22b',
    'qwen3-14b': 'qwen3_14b',
    'minicpm-2b': 'minicpm_2b',
    'codeqwen1.5-7b': 'codeqwen15_7b',
    'qwen2.5-14b': 'qwen25_14b',
    'whisper-base': 'whisper_base',
    'llama-3.2-vision-90b': 'llama32_vision_90b',
    'hymba-1.5b': 'hymba_1_5b',
    'chipmunk-ctc': 'chipmunk_ctc',
}

ASSIGNED_ARCHS = [a for a in ARCH_MODULES if a != 'chipmunk-ctc']


def get_config(name: str) -> ArchConfig:
    """The full configuration of architecture ``name``."""
    return importlib.import_module(f'.{ARCH_MODULES[name]}', __package__).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    """The reduced same-family configuration of ``name`` for CPU tests."""
    return importlib.import_module(f'.{ARCH_MODULES[name]}', __package__).SMOKE



def long_context_supported(cfg: ArchConfig) -> bool:
    """``long_500k`` runs only for the sub-quadratic architectures: the
    recurrent families, and sliding-window attention with no global
    layer."""
    return (cfg.family in ('ssm', 'hybrid')
            or (cfg.sliding_window is not None and not cfg.global_layer_ids))


def shapes_for(cfg: ArchConfig) -> List[ShapeConfig]:
    """The shapes of ``SHAPES`` that ``cfg`` runs, in order."""
    return [s for s in SHAPES.values()
            if s.name != 'long_500k' or long_context_supported(cfg)]
