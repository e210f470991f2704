"""CPU tests of the benchmark (cards-only tests carry the ``cuda`` marker)."""
