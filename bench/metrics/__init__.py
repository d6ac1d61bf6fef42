"""The per-layer metrics, one reader each: ``read(record) -> float or
None``, over the traced run's record (``tracing.reduce``, with the
adapter's ``work`` and ``setup`` added). A reader that finds nothing to
read returns ``None`` and the harness leaves the metric out."""
