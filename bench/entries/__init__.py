"""Entries into the system under test, one file per entry point that a
configuration names (``"entry"``).  An entry builds the program from the
benchmark's weights and exposes the calls the drive loops make; it is the
only place that imports the program (``repro_torch``)."""
