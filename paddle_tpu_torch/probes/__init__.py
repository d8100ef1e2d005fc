"""Probes run on the card to measure one kernel's design decisions;
each prints what a design note in ``PERF.md`` cites; and ``op_cases``,
the op library's cases that the CPU tests and ``chip_smoke.py`` share.
Nothing here is on a serving path."""
