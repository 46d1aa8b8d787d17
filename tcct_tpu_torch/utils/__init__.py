"""Utilities (JAX counterpart ``tcct_tpu/utils``): structured metric
logging, profiling, and the serving path's spans (``tracing``)."""

from tcct_tpu_torch.utils.logging import MetricLogger
from tcct_tpu_torch.utils.profiling import (
    cost_analysis,
    debug_nans,
    measured_traffic,
    trace,
)
