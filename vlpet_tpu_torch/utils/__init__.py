"""Shared utilities of the port: loss metering and metrics logging."""

from vlpet_tpu_torch.utils.logging import LossMeter, MetricsLogger
