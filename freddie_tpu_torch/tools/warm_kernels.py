"""Build the port's CUDA kernels ahead of a run.

    python -m freddie_tpu_torch.tools.warm_kernels

nvcc at first use is the port's only compile: ``ops/_build.py`` builds
``csrc/segdp.cu`` for sm_90a into ``freddie_tpu_torch/build/``, named by a
hash of the sources and flags, and every later process loads that file.
This runs the build now and prints its path, nvcc's seconds (0.00 when a
build of these sources was already there) and what ptxas reported per
kernel (registers, spills). Without nvcc it fails.
"""

from __future__ import annotations

import argparse
import sys

from ..ops._build import load_library


def warm(log=print) -> str:
    """Builds (or loads) the library; its path."""
    built = load_library("segdp")
    log(f"[warm] {built.path}: nvcc {built.seconds:.2f} s")
    for ln in built.log.splitlines():
        if "registers" in ln or "spill" in ln:
            log(f"[warm] {ln.strip()}")
    return built.path


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    warm(lambda *a: print(*a, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
