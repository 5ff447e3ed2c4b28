"""The benchmark of ``freddie_tpu_torch`` on one H100.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once and prints one JSON line. What
belongs to one configuration, traffic mix or per-layer metric sits in a
file of its own, found by its name: ``configs/<config>.json``,
``traffic/<mix>.json`` (data, which the one generator ``generator.py``
drives), ``metrics/<metric>.py`` (end-to-end and per-layer alike). The
yardstick (the
simulator, the bound, the reference that decides ``correct``) lives here
in frozen copies that import nothing of the program (``frozen/``,
``reference/``).
"""
