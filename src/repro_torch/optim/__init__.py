from .optimizers import (AdamWState, Optimizer, adamw, apply_updates,
                         clip_by_global_norm, cosine_schedule, global_norm,
                         make_optimizer)

__all__ = ['AdamWState', 'Optimizer', 'adamw', 'apply_updates',
           'clip_by_global_norm', 'cosine_schedule', 'global_norm',
           'make_optimizer']
