"""Utilities of the port: structured metrics (``profiling``)."""

from .profiling import MetricsLogger, StepTimer

__all__ = ["MetricsLogger", "StepTimer"]
