"""freddie_tpu_torch: the freddie-tpu pipeline on PyTorch and CUDA.

A port of ``freddie_tpu`` (JAX on a TPU) to one NVIDIA Hopper GPU. The
JAX package stays the reference: this package imports its jax-free host
code (I/O codec, thresholds, the float surface, the native C/C++ engines,
the split and isoforms stages, the cluster stage's preprocessing and
exact solvers) and replaces only the modules that reach ``jax``:

- ``ops.segdp``: batched segmentation DP dispatch, with the plain
  PyTorch twin of the XLA kernel;
- ``ops.segdp_cuda`` + ``csrc/segdp.cu``: the hand-written CUDA kernels
  that replace the two Pallas kernels (``freddie_tpu/ops/segdp_pallas.py``);
- ``ops.coverage``: coverage built on the device;
- ``solver.segenum`` / ``solver.two_phase``: the cluster solver's wide
  and closure rungs with their bounds in torch;
- ``stages.segment`` / ``stages.cluster`` / ``stages.pipeline``: the
  stages that route to them.

Every device decision is explicit: functions take a ``device`` argument,
CUDA tensors run the kernel, CPU tensors the plain version. This package
never imports ``jax``.
"""

__version__ = "0.1.0"

__all__ = ["run_pipeline", "PipelineConfig"]


def __getattr__(name):
    # Lazy convenience exports (keep bare `import freddie_tpu_torch` light).
    if name == "run_pipeline":
        from .stages.pipeline import run_pipeline

        return run_pipeline
    if name == "PipelineConfig":
        from .config import PipelineConfig

        return PipelineConfig
    raise AttributeError(name)
