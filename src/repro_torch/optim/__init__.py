from .compress import (compress_tensor, compress_with_feedback,
                       decompress_tensor, init_error_state, psum_compressed)
from .optimizers import (AdafactorState, AdamWState, OPTIMIZERS, Optimizer,
                         SGDState, adafactor, adamw, apply_updates,
                         clip_by_global_norm, clip_by_global_norm_,
                         cosine_schedule, global_norm, make_optimizer,
                         optimizer_state_axes, sgd, wsd_schedule)

__all__ = ['compress_tensor', 'compress_with_feedback', 'decompress_tensor',
           'init_error_state', 'psum_compressed', 'AdafactorState', 'AdamWState', 'OPTIMIZERS', 'Optimizer',
           'SGDState', 'adafactor', 'adamw', 'apply_updates',
           'clip_by_global_norm', 'clip_by_global_norm_', 'cosine_schedule',
           'global_norm', 'make_optimizer', 'optimizer_state_axes', 'sgd',
           'wsd_schedule']
