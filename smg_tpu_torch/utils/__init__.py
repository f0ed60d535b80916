import math

from smg_tpu_torch.utils.logging import get_logger


def percentile(samples: "list[float]", q: int) -> float:
    """Nearest-rank percentile over a copy (0 for an empty sample set):
    the value at rank ceil(q/100 * N), 1-indexed.  Shared by the engine
    flight recorder and the gateway SLO tracker so their reported
    percentiles stay method-identical."""
    if not samples:
        return 0.0
    s = sorted(samples)
    rank = max(1, math.ceil(q * len(s) / 100))
    return s[min(len(s) - 1, rank - 1)]


__all__ = ["get_logger", "percentile"]
