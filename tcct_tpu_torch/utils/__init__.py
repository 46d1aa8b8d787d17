"""Utilities (JAX counterpart ``tcct_tpu/utils``): structured metric
logging, tracing and profiling."""

from tcct_tpu_torch.utils.logging import MetricLogger
from tcct_tpu_torch.utils.profiling import (
    StepTimer,
    cost_analysis,
    debug_nans,
    measured_traffic,
    trace,
)
