"""One reader a metric, named as in BENCHMARK.json: ``read(run)`` takes a
``harness.Run`` and returns the value, or None where it finds nothing to
read (the harness then leaves the metric out). ``SPANS``, where given,
names the program's methods whose calls the traced run times
(``spans.Spans``) for it."""
