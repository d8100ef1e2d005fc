"""Probes run on the card to measure one kernel's design decisions;
each prints what a design note in ``PERF.md`` cites. Nothing here is on
a serving path."""
