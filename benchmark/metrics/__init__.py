"""Per-metric readers, one file a metric, found by name (``harness/cell.py``)."""
