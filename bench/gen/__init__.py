"""Input generators of the benchmark, one module per configuration's
``generator`` key, each with ``make(params, seed) -> dict``."""
