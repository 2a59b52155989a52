"""Observability of the PyTorch port: a metrics registry (``metrics``) and
a Chrome-trace span tracer (``trace``), both copies of ``repro.obs``.

Kernel-dispatch telemetry lives in ``kernels.ops``: every dispatcher records
which path ran (``cuda-kernel`` or ``cpu-plain``) per call site and counts
``kernel_dispatch_total.<site>.<path>`` in executed calls.
"""
