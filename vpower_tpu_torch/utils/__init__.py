from .profiling import StageTimer, Progress, trace, sync, log
from .checks import ConservationReport, check_conservation

__all__ = [
    "ConservationReport", "check_conservation",
    "StageTimer", "Progress", "trace", "sync", "log",
]
