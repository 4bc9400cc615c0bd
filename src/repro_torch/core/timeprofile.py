"""Time profile T(M) = a + b * m analysis (paper Thm 2, Eqs 3-4)."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass
class TimeProfile:
    """T(m groups) = a + b*m for a fixed group size; with the Hockney factor
    tau = L + group_bytes/B the dimensionless ratios a_hat = a/tau and
    b_hat = b/tau are size-independent (paper §2.3)."""

    a: float
    b: float                      # = Delta, the steady-state period per group
    tau: float                    # unit time L + min_k(M_k)/B

    @property
    def a_hat(self) -> float:
        return self.a / self.tau

    @property
    def b_hat(self) -> float:
        return self.b / self.tau


def fit_time_profile(ms: Sequence[int], times: Sequence[float],
                     tau: float) -> TimeProfile:
    """Least-squares fit of T = a + b*m (validates Thm 2's affinity)."""
    n = len(ms)
    sx = sum(ms)
    sy = sum(times)
    sxx = sum(m * m for m in ms)
    sxy = sum(m * t for m, t in zip(ms, times))
    denom = n * sxx - sx * sx
    b = (n * sxy - sx * sy) / denom
    a = (sy - b * sx) / n
    return TimeProfile(a=a, b=b, tau=tau)


def optimal_group_count(a_hat: float, b_hat: float, message_bytes: float,
                        latency: float, bandwidth: float) -> int:
    """m_opt = sqrt(a_hat*M / (b_hat*L*B)) (paper Eq. 3)."""
    if latency <= 0:
        return max(1, int(message_bytes))
    m = math.sqrt(a_hat * message_bytes / (b_hat * latency * bandwidth))
    return max(1, int(round(m)))


def optimal_time(a_hat: float, b_hat: float, message_bytes: float,
                 latency: float, bandwidth: float) -> float:
    """T_opt = a_hat*L + b_hat*M/B + 2*sqrt(a_hat*b_hat*L*M/B) (paper Eq. 4)."""
    bb = message_bytes / bandwidth
    return a_hat * latency + b_hat * bb + \
        2.0 * math.sqrt(a_hat * b_hat * latency * bb)
