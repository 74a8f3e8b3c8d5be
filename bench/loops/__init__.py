"""Drive loops: a cell names its loop (``"loop"`` in
``bench/workloads/<cell>.json``), ``bench/loops/<loop>.py``, which drives
the configuration's entry with the cell's traffic.

A loop is one function ``drive(system, traffic, pool, cell, seconds,
tracer, t_proc, seed)`` that warms up on its own traffic, measures for
``seconds``, traces ``cell['trace_s']`` more when ``tracer`` is given, and
returns a dict: ``setup_s`` (process start to the first timed frame),
``window_s``, ``frames`` (committed in the window), ``attempted``,
``failed``, ``trace`` (the trace summary and the ``readers.Traced`` calls,
or None), ``sample`` (the requests drawn from the seed for the
comparison, each with its ``frames``, ``length`` and the program's
outputs), and whatever else its metrics read (``readers.Context.run``).
"""
