"""Request arrival processes (paper §III-A uses Poisson @ 10 req/s)."""
from __future__ import annotations

import numpy as np


def poisson(rate: float, n: int, seed: int = 0, start: float = 0.0):
    """n arrival timestamps (seconds) of a Poisson process at ``rate`` req/s."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    return start + np.cumsum(gaps)


def gamma(rate: float, cv: float, n: int, seed: int = 0, start: float = 0.0):
    """Gamma-process arrivals: cv>1 burstier than Poisson, cv<1 smoother."""
    rng = np.random.default_rng(seed)
    shape = 1.0 / (cv ** 2)
    scale = cv ** 2 / rate
    gaps = rng.gamma(shape, scale, size=n)
    return start + np.cumsum(gaps)


def uniform(rate: float, n: int, start: float = 0.0):
    return start + np.arange(1, n + 1) / rate


def diurnal(rate: float, n: int, period: float = 60.0,
            amplitude: float = 0.8, cv: float = 1.0, seed: int = 0,
            start: float = 0.0):
    """Inhomogeneous arrivals with a sinusoidal intensity — the diurnal
    load shape fleet-scale serving studies sweep (peaks stress routing
    and KV headroom; troughs exercise the decode fast-forward).

    Intensity ``lambda(t) = rate * (1 + amplitude * sin(2*pi*(t - start)
    / period))``, realized by Lewis-Shedler thinning against the peak
    rate.  ``cv`` shapes the candidate gap process (1 = exponential /
    Poisson thinning; > 1 layers burstiness on top of the diurnal
    envelope via gamma gaps).
    """
    if not 0.0 <= amplitude < 1.0 + 1e-12:
        raise ValueError(f"amplitude must be in [0, 1], got {amplitude}")
    rng = np.random.default_rng(seed)
    peak = rate * (1.0 + amplitude)
    if cv == 1.0:
        def gap():
            return rng.exponential(1.0 / peak)
    else:
        shape = 1.0 / (cv ** 2)
        scale = cv ** 2 / peak

        def gap():
            return rng.gamma(shape, scale)
    out = np.empty(n)
    t = start
    k = 0
    while k < n:
        t += gap()
        lam = rate * (1.0 + amplitude
                      * np.sin(2.0 * np.pi * (t - start) / period))
        if rng.uniform() * peak <= lam:
            out[k] = t
            k += 1
    return out
