"""Per-layer metrics: ``metrics/<name>.py`` for each ``per_layer`` entry
of ``BENCHMARK.json``, found by its name.

A reader module defines ``read(obs)`` (``harness.Observation``), which
returns the metric's value, or None where the run has nothing to read.
It may also define:

- ``PROBE``, ``"<module>:<function>"`` of the program, and
  ``record(*args, **kwargs)``: while the profiler records device time,
  every call of that function is passed to ``record`` first, and what it
  returns is kept in ``obs.trace["launches"][<name>]``;
- ``describe(obs)``: a dict printed on the traced run's first line.
"""
