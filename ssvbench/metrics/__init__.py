"""Per-layer metrics, one reader a file named as the metric: ``read(window)``
returns the metric's value, or None where this run gives it nothing to
read (the harness then leaves the metric out of the line). ``window`` is
:class:`ssvbench.run.Window`."""
