"""Per-layer metrics, one file each, named as in ``BENCHMARK.json``.  Each
defines ``read(ctx)`` returning the metric's value, or None where the run
gives it nothing to read.  ``ctx``: ``trace`` (``trace.TraceSummary`` of
the traced pass), ``spans`` (host seconds by name over the window's other
passes), ``counters``, ``work`` (``Driver.pass_work()``), ``config``."""
