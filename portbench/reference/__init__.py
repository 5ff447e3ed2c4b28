"""The plain reference that decides ``correct``.

Plain NumPy and PyTorch, importing nothing of the program. It works out
again, from the benchmark's own simulated BAM, what a checked pass
produced, and holds the pass's outputs to it (``check.py``). Where it can
only follow the program from the program's own state (the candidate
positions of phase A's DP problems, the cluster stage's read-to-isoform
assignment), the stage it follows from is checked by itself: PERF.md
says which. The DP's operands (each problem's coverage and weights) it
works out again from the BAM.
"""
