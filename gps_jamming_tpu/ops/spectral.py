"""Welch PSD and spectrogram kernels.

Device replacement for the reference's `scipy.signal.welch` usage
(`skrypty/widmo_plot.py:48-53`: nperseg=1024, two-sided, hann, 50% overlap,
density scaling, then fftshift + 10*log10). Implemented as batched jnp.fft so
XLA tiles the FFTs and fuses the windowing/scaling elementwise ops.

Parity is validated against scipy in tests/test_spectral.py.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import cplx, fftcore
from .iq import frame, remove_dc


@functools.lru_cache(maxsize=16)
def _hann(nperseg: int) -> np.ndarray:
    # scipy.signal.get_window('hann', n) is the periodic=False symmetric hann
    # used by welch with default args? scipy uses sym=False for spectral
    # windows: get_window -> fftbins=True (periodic). Match that.
    n = np.arange(nperseg)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / nperseg)).astype(np.float32)


def welch_psd(iq: jax.Array, sample_rate: float, nperseg: int = 1024,
              overlap_frac: float = 0.5, detrend: bool = True) -> jax.Array:
    """Two-sided Welch PSD, density scaling, natural FFT order.

    Matches scipy.signal.welch(x, fs, nperseg=nperseg, return_onesided=False)
    with the default hann window and 50% overlap, including the per-segment
    constant detrend. Batches over leading dims. Output (..., nperseg).
    """
    return welch_psd_p(cplx.asarray(iq), sample_rate, nperseg,
                       overlap_frac, detrend)


def welch_psd_p(x: cplx.CArray, sample_rate: float, nperseg: int = 1024,
                overlap_frac: float = 0.5, detrend: bool = True) -> jax.Array:
    """Planar-complex Welch core (the device path of `welch_psd`)."""
    hop = int(nperseg * (1.0 - overlap_frac))
    win = jnp.asarray(_hann(nperseg))
    segs = cplx.apply(lambda a: frame(a, nperseg, hop), x)
    if detrend:
        segs = cplx.apply(lambda a: remove_dc(a, axis=-1), segs)
    segs = cplx.CArray(segs.re * win, segs.im * win)
    p = fftcore.fft_power_p(segs)
    scale = 1.0 / (sample_rate * jnp.sum(win * win))
    return jnp.mean(p, axis=-2) * scale


def psd_db_shifted(pxx: jax.Array) -> jax.Array:
    """fftshift + 10*log10(P + 1e-15)  (widmo_plot.py:51-52)."""
    return 10.0 * jnp.log10(jnp.fft.fftshift(pxx, axes=-1) + 1e-15)


def spectrogram(iq: jax.Array, sample_rate: float, chunk_samples: int,
                nperseg: int = 1024, overlap_frac: float = 0.5) -> jax.Array:
    """Waterfall: Welch PSD per non-overlapping time chunk, in shifted dB.

    Re-expresses the widmo_plot.py per-second loop as one batched call:
    (n,) -> (n_chunks, nperseg) dB matrix.  The per-chunk DC removal of
    widmo_plot.py:44 is applied before the per-segment detrend.
    """
    return spectrogram_p(cplx.asarray(iq), sample_rate, chunk_samples,
                         nperseg, overlap_frac)


def spectrogram_p(x: cplx.CArray, sample_rate: float, chunk_samples: int,
                  nperseg: int = 1024, overlap_frac: float = 0.5) -> jax.Array:
    """Planar-complex spectrogram core."""
    n_chunks = x.shape[-1] // chunk_samples

    def chunked(a):
        a = a[..., : n_chunks * chunk_samples]
        return a.reshape(a.shape[:-1] + (n_chunks, chunk_samples))

    xc = cplx.apply(chunked, x)
    xc = cplx.apply(lambda a: remove_dc(a, axis=-1), xc)
    pxx = welch_psd_p(xc, sample_rate, nperseg, overlap_frac)
    return psd_db_shifted(pxx)


def freq_axis_mhz(sample_rate: float, nperseg: int) -> np.ndarray:
    """Shifted frequency axis in MHz (widmo_plot.py:76)."""
    return np.linspace(-sample_rate / 2 / 1e6, sample_rate / 2 / 1e6, nperseg)


def mean_spectrum_db(spectrogram_db: jax.Array) -> jax.Array:
    """Mean over time of the dB spectrogram (widmo_plot.py:75)."""
    return jnp.mean(spectrogram_db, axis=-2)


def spectrogram_file(path: str, sample_rate: float, chunk_samples: int,
                     nperseg: int = 1024, overlap_frac: float = 0.5,
                     max_samples: int | None = None,
                     batch_chunks: int = 16) -> "np.ndarray":
    """Bounded-memory waterfall from a capture FILE.

    Streams `batch_chunks` spectrogram chunks at a time (host/device
    memory = one batch, independent of capture length) and produces the
    SAME rows as `spectrogram` on the fully-loaded capture: chunking,
    per-chunk DC removal and Welch segmentation all happen at chunk
    granularity, so batch boundaries cannot change any value."""
    import os

    from . import iq as iq_ops

    n_total = os.path.getsize(path) // 2
    if max_samples is not None:
        n_total = min(n_total, int(max_samples))
    n_chunks = n_total // chunk_samples
    rows = []
    g0 = 0
    jfn = jax.jit(lambda xr, xi: spectrogram_p(
        cplx.CArray(xr, xi), sample_rate, chunk_samples, nperseg,
        overlap_frac))
    while g0 < n_chunks * chunk_samples:
        m = min(batch_chunks * chunk_samples,
                n_chunks * chunk_samples - g0)
        x = iq_ops.read_iq_file(path, convention="normalized",
                                count=2 * m, offset_bytes=2 * g0)
        if x.size == 0:
            break
        xp = cplx.from_complex(jnp.asarray(x.astype(np.complex64)))
        rows.append(np.asarray(jfn(xp.re, xp.im)))
        g0 += x.size
    if not rows:
        return np.zeros((0, nperseg), np.float32)
    return np.concatenate(rows, axis=0)
