"""The paper's lifecycle examples on the port, run as modules::

    python -m repro_torch.examples.quickstart
    python -m repro_torch.examples.speech_ctc --steps 60

They live in the package because the repository's ``examples/`` holds the
reference's own.  Both run on the card unless ``--device cpu`` is given.
"""
