"""The read simulator the port's checks drive the pipeline with: the JAX
package's jax-free simulator (spliced transcripts -> noisy aligned reads
-> BAM + FASTQ, with the truth isoforms), re-exported."""

from freddie_tpu.utils.sim import simulate  # noqa: F401
