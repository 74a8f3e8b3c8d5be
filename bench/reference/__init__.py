"""Plain references of the benchmark's configurations: PyTorch only, no
kernel, no cache, no batching of their own, and nothing of the program.

A configuration names its reference, ``bench/reference/<name>.py``, which
gives the harness all that is particular to the model:

- ``make_weights(cfg, seed, device)``: the weights, made on the device
  from the seed and handed alike to the program and to the reference;
- ``make_inputs(cfg, n_frames, seed, device)``: the pool of input frames
  that every request's frames are a window of;
- ``macs_per_frame(cfg)``: the network's multiply-accumulates a frame;
- ``readings(weights, frames, got)``: the numbers compared, for the
  program's outputs ``got`` (one dict a sampled request), or, with ``got``
  None, for the reference in the nearest lower precision in the program's
  place (the control).
"""
