"""One reader per metric of BENCHMARK.json, end-to-end and per-layer alike,
found by the metric's name (``metrics/<name>.py``).

Every module gives ``read(ctx)``: the metric's value, or None where it
finds nothing to read (the harness then leaves the metric out).  An
untraced run reads the cell's end-to-end metrics, a traced run its
per-layer metrics, from one context:

- ``cell``: the cell (harness/spec.py); ``chips``: the cards the run used;
- ``work``: work/<kind>.py's count of one call;
- ``setup_s``: process start to the window's first call;
- ``stats``: the window (harness/window.py ``Stats``: calls, failed calls,
  ``t_open`` / ``t_close``); ``window_s``: its length;
- ``host_s``: host seconds inside each untraced entry call;
- traced runs: ``events`` (the profiler's raw Chrome-trace events, for a
  reader's own reduction with harness/tracing.py's helpers), ``trace``
  (tracing.reduce_events of them) and ``traced_calls``; None and 0 in an
  untraced run;
- untraced runs of a cell with an end-to-end metric from the device trace:
  ``window_busy_s`` (the device's busy seconds over the window's calls,
  tracing.WindowMeter) and ``metered_calls`` (those calls); None and 0
  where no meter ran or it read nothing.

A metric named ``<base>.<variant>`` is read from ``metrics/<base>.<variant>.py``.
"""
