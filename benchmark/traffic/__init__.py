"""Traffic drivers, one module per kind, each with a ``Driver``."""
