"""Traffic drivers, one module a kind, found by the ``driver`` key of a
traffic mix (``benchmark/traffic/<mix>.json``)."""
