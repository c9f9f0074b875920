"""One reader a metric: ``<metric name>.py`` with ``read(rec) -> float |
None``, loaded by the harness from its file.  ``rec`` is the run's record
(``graphbench.harness.window``); a reader that finds nothing to read
returns None and the metric is left out of the line."""
