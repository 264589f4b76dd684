from .checks import ConservationReport, check_conservation

__all__ = ["ConservationReport", "check_conservation"]
