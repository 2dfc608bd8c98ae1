"""One reader a metric: ``read(rec)`` takes the metric from a run's record
(``harness.run_cell``) and returns its value, or None where the run has
nothing to read; the harness then leaves the metric out of the line."""
