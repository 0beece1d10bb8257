"""Per-layer metrics, one reader a module, found by the metric's name."""
