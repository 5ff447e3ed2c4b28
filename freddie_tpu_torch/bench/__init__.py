"""The port's benchmarks: ``bench.segment`` (the segment-stage headline),
``bench.scaling_pipeline`` (processes on gloo) and what they share with
``chip_smoke.py`` (``bench.common``). Each is run with ``python -m``."""
