"""Utilities (JAX counterpart ``tcct_tpu/utils``): structured metric logging."""

from tcct_tpu_torch.utils.logging import MetricLogger
