from .profiling import (StageTimer, Progress, trace, sync, log, span,
                        span_report, counter_report)
from .checks import ConservationReport, check_conservation
from .plotting import (
    plot_density_slice,
    plot_velocity_slice,
    peek_field,
    plot_spectrum,
    peek_spectrum,
)

__all__ = [
    "ConservationReport", "check_conservation",
    "StageTimer", "Progress", "trace", "sync", "log", "span", "span_report",
    "counter_report",
    "plot_density_slice", "plot_velocity_slice", "peek_field",
    "plot_spectrum", "peek_spectrum",
]
