"""The port's tooling, one module per script of the repository's
``tools/`` directory, each run as ``python -m freddie_tpu_torch.tools.<name>``
(``--help`` says what it takes)."""
