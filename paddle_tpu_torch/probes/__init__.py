"""Probes run on the card to measure one kernel's design decisions; each
prints what a design note in ``PERF.md`` cites; the measurement probes of
the reference's ``tools/`` (``pipeline``, ``mfu``, ``rn50_raw``,
``layout``, ``quant_matmul``, ``trace``, ``paged_cache``, ``generate``,
``decode_policy``), each ``python3 -m paddle_tpu_torch.probes.<name>``;
and ``op_cases``, the op library's cases that the CPU tests and
``chip_smoke.py`` share. Nothing here is on a serving path."""
