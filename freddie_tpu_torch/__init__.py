"""freddie_tpu_torch: the freddie-tpu pipeline on PyTorch and CUDA.

A port of ``freddie_tpu`` (JAX on a TPU) to NVIDIA Hopper GPUs, and a
package of its own: it imports ``torch``, never ``jax`` and nothing of
``freddie_tpu``. Each module sits where its counterpart sits there
(``freddie_tpu/io/tsv.py`` <-> ``freddie_tpu_torch/io/tsv.py``). The host
code (I/O codecs, thresholds, the float surface, the loaders of the
native C/C++ engines under ``native/``, the split and isoforms stages,
the cluster stage's preprocessing and exact solvers) is that package's
code as it is; what reached ``jax`` there has a torch counterpart:

- ``ops.segdp``: batched segmentation DP dispatch, with the plain
  PyTorch twin of the XLA kernel;
- ``ops.segdp_cuda`` + ``csrc/segdp.cu``: the hand-written CUDA kernels
  that replace the two Pallas kernels (``freddie_tpu/ops/segdp_pallas.py``);
- ``ops.coverage``: coverage built on the device;
- ``solver.segenum`` / ``solver.two_phase``: the cluster solver's wide
  and closure rungs with their bounds in torch;
- ``ops.polya_batch``: the batched polyA scan;
- ``parallel.mesh``: one DP batch split over several cards;
- ``parallel.dist``: the multi-process pipeline on ``torch.distributed``;
- ``stages.segment`` / ``stages.cluster`` / ``stages.pipeline`` /
  ``stages.workflow``: the stages and runners that route to them.

Every routing gate and constant is the module's own, equal in value to
the JAX package's. Every device decision is explicit: functions take a
``device`` argument, CUDA tensors run the kernel, CPU tensors the plain
version.
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
