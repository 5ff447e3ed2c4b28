"""Frozen copies of what the benchmark takes from the program's history.

Each module here was copied from ``freddie_tpu_torch`` and rewritten to
import nothing of it, so a later change to the program cannot move the
yardstick: the read simulator and the BAM / FASTQ writing it needs
(``sim``, ``bamio``), the card's bound for one DP call (``bound``) and
the recovery arithmetic against simulation truth (``recovery``).
"""
