"""The metric readers: metrics/<name>.py for every metric of
BENCHMARK.json, each with ``read(record)``, the metric's value from a
run's record (run.run_cell), or None where the run gave it nothing to
read.  ``common`` holds what several of them share."""
