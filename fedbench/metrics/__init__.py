"""One file a metric, named as in ``BENCHMARK.json``: ``read(rec)`` takes
the run's record (see ``fedbench/harness.py``) and returns the number, or
None where the run has nothing to read for it (then the metric is left
out of the result)."""
