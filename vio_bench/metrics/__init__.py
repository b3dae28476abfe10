"""One reader a metric: ``<name>.py`` defines ``read(run)``, the metric's value
from a run's readings (``cell.run``'s result), or None where the run holds
nothing to read it from (the harness then leaves the metric out)."""
