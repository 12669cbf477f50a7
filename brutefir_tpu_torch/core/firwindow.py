"""Kaiser FIR window with fractional offset (reference `firwindow.c:14-162`).

Runs at init time only, so plain numpy/float64 is fine. The fractional-offset
branch of the reference applies the window value *twice* to each tap
(`firwindow.c:107-113` repeats ``target[n] *= y``); we reproduce that
behavior exactly since the subsample-delay filter bank depends on it.
"""

from __future__ import annotations

import math

import numpy as np


def i_zero(x: float) -> float:
    """Zeroth-order modified Bessel function, dynamic-range-friendly series."""
    halfx = x / 2.0
    total = 1.0
    a = 1.0
    n = 1.0
    while True:
        a *= halfx
        a /= n
        total += a * a
        n += 1.0
        if a == 0.0 or not math.isfinite(total):
            break
    return total


def _kaiser(x: float, beta: float, inv_izbeta: float) -> float:
    x = min(1.0, max(-1.0, x))
    return i_zero(beta * math.sqrt(1.0 - x * x)) * inv_izbeta


def firwindow_kaiser(target: np.ndarray, offset: float, beta: float) -> None:
    """Apply the Kaiser window in place to ``target`` (any float dtype).

    Store semantics follow the reference exactly: the window value y stays
    DOUBLE and each store rounds the double product to the target dtype
    (`((float *)target)[n] *= y` promotes through double,
    firwindow.c:107-113) -- pre-rounding y to float32 diverges by 1 ulp
    on the fractional-offset branch (golden-vector verified).
    """
    length = target.shape[0]
    len_div2 = length >> 1
    inv_izbeta = 1.0 / i_zero(beta)
    rt = target.dtype.type

    def mul(i, y):
        target[i] = rt(float(target[i]) * y)

    if offset != 0.0:
        mx = len_div2 + int(math.floor(offset))
        offset -= math.floor(offset)
        if abs(offset) < 1e-20:
            offset = 0.0
        step = 1.0 / (float(mx) + offset)
        if offset == 0.0:
            mx -= 1
        n = 0
        while n <= mx:
            y = _kaiser(-1.0 + float(n) * step, beta, inv_izbeta)
            mul(n, y)
            mul(n, y)  # applied twice, as in the reference
            n += 1
        if offset == 0.0:
            mx += 1
        step = 1.0 / (float(length - mx - 1) - offset)
        while n < length:
            y = _kaiser((float(n - mx) - offset) * step, beta, inv_izbeta)
            mul(n, y)
            mul(n, y)
            n += 1
    elif length & 1:
        step = 1.0 / float(len_div2)
        for n in range(1, len_div2 + 1):
            y = _kaiser(float(n) * step, beta, inv_izbeta)
            mul(len_div2 + n, y)
            mul(len_div2 - n, y)
    else:
        step = (1.0 / float(len_div2)) * (float(len_div2) / (float(len_div2) - 0.5))
        for n in range(1, len_div2 + 1):
            y = _kaiser((float(n) - 0.5) * step, beta, inv_izbeta)
            mul(len_div2 + n - 1, y)
            mul(len_div2 - n, y)


def sample_sinc(half_length: int, offset: float, kaiser_beta: float,
                dtype=np.float32) -> np.ndarray:
    """Windowed-sinc fractional-delay FIR (reference `delay.c:54-75`)."""
    length = 2 * half_length + 1
    n = np.arange(length, dtype=np.float64)
    x = math.pi * (n - half_length - offset)
    with np.errstate(invalid="ignore"):
        f = np.where(x == 0.0, 1.0, np.sin(x) / np.where(x == 0.0, 1.0, x))
    filt = f.astype(dtype)
    firwindow_kaiser(filt, offset, kaiser_beta)
    return filt
