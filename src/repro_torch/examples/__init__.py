"""The paper's lifecycle examples on the port, run as modules::

    python -m repro_torch.examples.quickstart
    python -m repro_torch.examples.speech_ctc --steps 60
    python -m repro_torch.examples.serve_lm --arch qwen3-14b
    python -m repro_torch.examples.train_lm --steps 300

They live in the package because the repository's ``examples/`` holds the
reference's own.  All four run on the card unless ``--device cpu`` is given.
"""
