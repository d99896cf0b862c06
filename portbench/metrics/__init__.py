"""One reader a metric: ``read(run)`` of the run's record
(``core/cell.py::Run``), the metric's value, or ``None`` where the run holds
nothing for it to read (the harness then leaves the metric out).  The
harness finds ``<name>.py`` by the metric's name in ``BENCHMARK.json``."""
