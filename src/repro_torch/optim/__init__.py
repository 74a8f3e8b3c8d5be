from .optimizers import (AdafactorState, AdamWState, OPTIMIZERS, Optimizer,
                         SGDState, adafactor, adamw, apply_updates,
                         clip_by_global_norm, clip_by_global_norm_,
                         cosine_schedule, global_norm, make_optimizer, sgd,
                         wsd_schedule)

__all__ = ['AdafactorState', 'AdamWState', 'OPTIMIZERS', 'Optimizer',
           'SGDState', 'adafactor', 'adamw', 'apply_updates',
           'clip_by_global_norm', 'clip_by_global_norm_', 'cosine_schedule',
           'global_norm', 'make_optimizer', 'sgd', 'wsd_schedule']
