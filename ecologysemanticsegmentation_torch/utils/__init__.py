"""Utilities of the port: structured metrics (``profiling``), the overlay
colours, the composite-label overlays and the edge analysis."""

from .colors import COLORS
from .edges import detect_edge_pred_overlap, detect_edges, detect_inner_edges
from .profiling import MetricsLogger, StepTimer
from .visualize import display_composite_annotations

__all__ = [
    "COLORS", "MetricsLogger", "StepTimer", "detect_edge_pred_overlap", "detect_edges",
    "detect_inner_edges", "display_composite_annotations",
]
