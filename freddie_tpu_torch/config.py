"""Stage configurations of the port: the JAX package's dataclasses (pure
Python, defaults equal to the reference CLIs), re-exported so a user of
the port configures it without reaching into ``freddie_tpu``."""

from freddie_tpu.config import (  # noqa: F401
    ClusterConfig,
    IsoformsConfig,
    PipelineConfig,
    SegmentConfig,
    SplitConfig,
)
