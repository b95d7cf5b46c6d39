"""Correlation kernels: circular FFT correlation, full linear cross-correlation,
and sub-sample peak interpolation.

Batched equivalents of:
- `sdrcmn.c:124-147` (`cpxconv`: FFT circular correlation -> |.|^2 power),
  the reference's acquisition engine,
- `scipy.signal.correlate(sig1, sig0, mode='full')` as used by
  `triangulateTDOA.py:86-89`,
- plus parabolic sub-sample lag interpolation, which the reference lacks
  (integer-lag argmax only, `triangulateTDOA.py:89`) and BASELINE.md requires.

All kernels are batched jnp.fft — acquisition across (PRN x Doppler) and TDOA
across antenna pairs run as one large batched FFT.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import cplx, fftcore


def circular_correlation_power(x, replica_fft_conj) -> jax.Array:
    """|IFFT(FFT(x) * conj(FFT(replica)))|^2  (cpxconv, sdrcmn.c:124-147).

    Args:
      x: (..., n) complex or CArray baseband block.
      replica_fft_conj: (..., n) precomputed conj(FFT(code replica)).

    Returns float32 (..., n) correlation power over all circular lags.
    """
    xf = fftcore.fft_p(cplx.asarray(x))
    prod = cplx.mul(xf, replica_fft_conj
                    if isinstance(replica_fft_conj, cplx.CArray)
                    else cplx.asarray(replica_fft_conj))
    return fftcore.ifft_power_p(prod)


def xcorr_full_p(a: cplx.CArray, b: cplx.CArray) -> cplx.CArray:
    """Planar full linear cross-correlation via zero-padded FFT.

    out[k] = sum_n a[n + k - (Nb-1)] * conj(b[n]), length Na+Nb-1; the lag of
    out index m is m - (Nb - 1) (scipy.signal.correlate 'full' convention).
    """
    na = a.shape[-1]
    nb = b.shape[-1]
    nfft = int(2 ** np.ceil(np.log2(na + nb - 1)))
    af = fftcore.fft_p(a, n=nfft)
    bf = fftcore.fft_p(b, n=nfft)
    full = fftcore.ifft_p(cplx.mul_conj(af, bf))
    # circular result index (m - (nb-1)) mod nfft  ->  linear 'full' order
    idx = (jnp.arange(na + nb - 1) - (nb - 1)) % nfft
    return cplx.apply(lambda v: jnp.take(v, idx, axis=-1), full)


def xcorr_full(a: jax.Array, b: jax.Array) -> jax.Array:
    """Complex-dtype wrapper of `xcorr_full_p` (CPU/API boundary)."""
    return cplx.to_complex(xcorr_full_p(cplx.asarray(a), cplx.asarray(b)))


def argmax_lag(corr_mag: jax.Array, nb: int) -> jax.Array:
    """Integer lag of the correlation peak: argmax - (nb - 1)."""
    return (jnp.argmax(corr_mag, axis=-1) - (nb - 1)).astype(jnp.int32)


def parabolic_peak_offset(y: jax.Array, peak_idx: jax.Array) -> jax.Array:
    """Sub-sample offset of a discrete peak by 3-point parabola fit.

    offset = 0.5*(y[-1] - y[+1]) / (y[-1] - 2*y[0] + y[+1]), clamped to
    [-0.5, 0.5]; 0 when the peak is at the array edge or denominator ~ 0.
    """
    n = y.shape[-1]
    im = jnp.clip(peak_idx - 1, 0, n - 1)
    ip = jnp.clip(peak_idx + 1, 0, n - 1)
    ym = jnp.take_along_axis(y, im[..., None], axis=-1)[..., 0]
    y0 = jnp.take_along_axis(y, peak_idx[..., None], axis=-1)[..., 0]
    yp = jnp.take_along_axis(y, ip[..., None], axis=-1)[..., 0]
    denom = ym - 2.0 * y0 + yp
    offset = jnp.where(jnp.abs(denom) > 1e-12,
                       0.5 * (ym - yp) / denom, 0.0)
    offset = jnp.clip(offset, -0.5, 0.5)
    at_edge = (peak_idx <= 0) | (peak_idx >= n - 1)
    return jnp.where(at_edge, 0.0, offset)


def xcorr_peak_lag(a, b,
                   subsample: bool = True) -> tuple[jax.Array, jax.Array]:
    """Cross-correlation peak lag (float samples) and its magnitude.

    Integer part matches the reference TDOA (`triangulateTDOA.py:86-89`);
    the fractional part is the parabolic refinement required by BASELINE.md.
    Accepts complex or CArray inputs.
    """
    nb = b.shape[-1]
    c = xcorr_full_p(cplx.asarray(a), cplx.asarray(b))
    mag = jnp.sqrt(cplx.abs2(c))
    peak = jnp.argmax(mag, axis=-1)
    lag = (peak - (nb - 1)).astype(jnp.float32)
    if subsample:
        lag = lag + parabolic_peak_offset(mag, peak)
    pk = jnp.take_along_axis(mag, peak[..., None], axis=-1)[..., 0]
    return lag, pk


def second_peak_excluded(power_row: jax.Array, peak_idx: jax.Array,
                         exclude_half_width: int) -> jax.Array:
    """Max of a correlation row excluding a circular window around the peak.

    Mirrors `checkacquisition` (sdracq.c:52-68): exclusion spans
    [peak - w, peak + w] with circular wraparound.
    """
    n = power_row.shape[-1]
    pos = jnp.arange(n)
    dist = jnp.abs((pos - peak_idx[..., None] + n // 2) % n - n // 2)
    masked = jnp.where(dist <= exclude_half_width, -jnp.inf, power_row)
    return jnp.max(masked, axis=-1)


def mean_excluded(power_row: jax.Array, peak_idx: jax.Array,
                  exclude_half_width: int) -> jax.Array:
    """Mean of a row excluding the circular window around the peak (meanvd)."""
    n = power_row.shape[-1]
    pos = jnp.arange(n)
    dist = jnp.abs((pos - peak_idx[..., None] + n // 2) % n - n // 2)
    keep = dist > exclude_half_width
    s = jnp.sum(jnp.where(keep, power_row, 0.0), axis=-1)
    cnt = jnp.maximum(jnp.sum(keep, axis=-1), 1)
    return s / cnt
