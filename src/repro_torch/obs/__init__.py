"""Observability: unified metrics registry, Perfetto trace export,
critical-path attribution over ``repro_torch.core.trace`` flight-recorder
events, measured-cost calibration and the observed-load controller.

This package depends only on the standard library — ``repro_torch.core``
imports nothing from here at module scope, so there is no import cycle.
"""
from .calibrate import (
    CalibrationError,
    CalibrationProfile,
    fit_affine,
    fit_profile,
    load_profile,
    run_calibration,
    samples_from_recorder,
)
from .controller import (
    ControllerAction,
    ControllerPolicy,
    ObservedLoadController,
)
from .critical_path import (
    analyze,
    drift_lines,
    drift_report,
    summary_line,
    top_segments,
)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .perfetto import export_chrome_trace, write_chrome_trace

__all__ = [
    "CalibrationError",
    "CalibrationProfile",
    "ControllerAction",
    "ControllerPolicy",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ObservedLoadController",
    "analyze",
    "drift_lines",
    "drift_report",
    "export_chrome_trace",
    "fit_affine",
    "fit_profile",
    "load_profile",
    "run_calibration",
    "samples_from_recorder",
    "summary_line",
    "top_segments",
    "write_chrome_trace",
]
