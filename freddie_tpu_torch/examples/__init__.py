"""Worked examples on the port, run with ``python -m``."""
