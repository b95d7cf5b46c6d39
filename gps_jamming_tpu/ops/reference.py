"""Float64 NumPy twins of the acquisition kernels (the plain reference).

The device code (`ops.caf`, `models.receiver.acquisition`) builds its
search surfaces from planar float32 arrays, batched FFTs, replica-spectrum
shifts and small DFT contractions. The functions here compute the same
surfaces the direct way, one Doppler row at a time, in float64: each row
mixes the blocks down by that row's frequency in the time domain,
correlates against the unshifted replica, and sums. Tests and the on-GPU
smoke check compare the device kernels against them.
"""
from __future__ import annotations

import numpy as np


def _c128(x) -> np.ndarray:
    """complex array or CArray of (re, im) planes -> complex128 ndarray."""
    if hasattr(x, "re"):
        return np.asarray(x.re, np.float64) + 1j * np.asarray(x.im,
                                                             np.float64)
    return np.asarray(x, np.complex128)


def caf_accumulate_np(blocks, replica_fft_conj, freqs,
                      sample_rate: float) -> np.ndarray:
    """Non-coherent CAF power, (n_prn, n_freq, n): sum over blocks of
    |IFFT(FFT(block * e^{-j 2 pi f t}) * replica)|^2."""
    x = _c128(blocks)
    rep = _c128(replica_fft_conj)
    n = x.shape[-1]
    t = np.arange(n) / sample_rate
    freqs = np.asarray(freqs, np.float64)
    xf = np.fft.fft(x[:, None, :] * np.exp(-2j * np.pi * freqs[:, None]
                                           * t[None, :]), axis=-1)
    out = np.empty((rep.shape[0], freqs.size, n))
    for p in range(rep.shape[0]):
        y = np.fft.ifft(xf * rep[p], axis=-1)          # (B, F, n)
        out[p] = np.sum(np.abs(y) ** 2, axis=0)
    return out


def _pcf_rows(x: np.ndarray, rep: np.ndarray, mix_hz: np.ndarray,
              fine_hz: np.ndarray, sample_rate: float,
              n_groups: int) -> np.ndarray:
    """Coherent-group PCF power for explicit mixing frequencies.

    x: (B, n) blocks; rep: (P, n); mix_hz: (R,) per-row time-domain mix.
    Row r, fine f: blocks mixed by mix_hz[r] inside the block, phased by
    (mix_hz[r] + fine_f) across blocks, summed coherently within each of
    n_groups groups; group powers add. Returns (P, R, F, n).
    """
    nb, n = x.shape
    t = np.arange(n) / sample_rate
    t_block = n / sample_rate
    gl = nb // n_groups
    xf = np.fft.fft(x[None] * np.exp(-2j * np.pi * mix_hz[:, None, None]
                                     * t[None, None, :]), axis=-1)
    b = np.arange(nb)
    # (R, F, B) cross-block phase of the full row frequency
    w = np.exp(-2j * np.pi * (mix_hz[:, None, None] + fine_hz[None, :, None])
               * (b * t_block)[None, None, :])
    out = np.zeros((rep.shape[0], mix_hz.size, fine_hz.size, n))
    for g in range(n_groups):
        sl = slice(g * gl, (g + 1) * gl)
        z = np.einsum("rfb,rbk->rfk", w[:, :, sl], xf[:, sl])   # (R, F, n)
        for p in range(rep.shape[0]):
            out[p] += np.abs(np.fft.ifft(z * rep[p], axis=-1)) ** 2
    return out


def caf_accumulate_pcf_np(blocks, replica_fft_conj, sample_rate: float,
                          max_doppler_hz: float = 7000.0, n_sets: int = 2,
                          fine_hz=(-200.0, 0.0, 200.0),
                          n_groups: int = 2) -> np.ndarray:
    """Twin of `caf.caf_accumulate_pcf`: (n_prn, n_rows, n), rows ordered
    (coarse, set, fine) like `caf.pcf_doppler_hz`."""
    x = _c128(blocks)
    rep = _c128(replica_fft_conj)
    n = x.shape[-1]
    bin_hz = sample_rate / n
    n_c = 2 * int(np.floor(max_doppler_hz / bin_hz)) + 1
    coarse = (np.arange(n_c) - n_c // 2) * bin_hz
    sets = np.arange(n_sets) * (bin_hz / n_sets)
    mix = (coarse[:, None] + sets[None, :]).reshape(-1)
    fine = np.asarray(fine_hz, np.float64)
    out = _pcf_rows(x, rep, mix, fine, sample_rate, n_groups)
    return out.reshape(rep.shape[0], -1, n)


def caf_accumulate_pcf_fdma_np(blocks, replica_fft_conj, offsets_hz,
                               sample_rate: float,
                               max_doppler_hz: float = 7000.0,
                               n_sets: int = 2,
                               fine_hz=(-200.0, 0.0, 200.0),
                               n_groups: int = 2) -> np.ndarray:
    """Twin of `caf.caf_accumulate_pcf_fdma`: (n_ch, n_rows, n), one shared
    replica, each channel searched around its own carrier offset."""
    x = _c128(blocks)
    rep = _c128(replica_fft_conj).reshape(1, -1)
    n = x.shape[-1]
    bin_hz = sample_rate / n
    D = int(np.floor(max_doppler_hz / bin_hz))
    sets = np.arange(n_sets) * (bin_hz / n_sets)
    fine = np.asarray(fine_hz, np.float64)
    offs = np.asarray(offsets_hz, np.float64).reshape(-1)
    out = []
    for off in offs:
        # the channel's sub-bin remainder is removed exactly; the row grid
        # sits on whole bins from the channel's coarse bin
        base = np.floor(off / bin_hz) * bin_hz
        sub = off - base
        mix = (base + np.arange(-D, D + 1)[:, None] * bin_hz
               + sub + sets[None, :]).reshape(-1)
        out.append(_pcf_rows(x, rep, mix, fine, sample_rate,
                             n_groups)[0].reshape(-1, n))
    return np.stack(out)


def checkacquisition_np(surf, freqs, peak_ratio_threshold: float,
                        exclude_chips: float, code_period_s: float,
                        code_len_chips: float = 1023.0) -> dict:
    """Twin of `acquisition.acquisition_test` (sdracq.c:52-81) per PRN:
    peak over (Doppler, lag); second peak and mean over the peak's Doppler
    row outside a circular +/- exclude window; acquired when
    peak/second > threshold."""
    surf = np.asarray(surf, np.float64)
    n_prn, n_freq, n = surf.shape
    excl = int(exclude_chips * max(int(round(n / code_len_chips)), 1))
    idx = surf.reshape(n_prn, -1).argmax(axis=-1)
    freq_i, code_i = idx // n, idx % n
    out = {k: [] for k in ("acquired", "code_phase", "doppler_index",
                           "doppler_hz", "peak", "second", "mean",
                           "peak_ratio", "cn0_dbhz")}
    for p in range(n_prn):
        row = surf[p, freq_i[p]]
        d = np.abs((np.arange(n) - code_i[p] + n // 2) % n - n // 2)
        keep = d > excl
        peak = row[code_i[p]]
        second = row[keep].max()
        mean = row[keep].mean()
        ratio = peak / max(second, 1e-30)
        out["acquired"].append(ratio > peak_ratio_threshold)
        out["code_phase"].append(int(code_i[p]))
        out["doppler_index"].append(int(freq_i[p]))
        out["doppler_hz"].append(float(np.asarray(freqs)[freq_i[p]]))
        out["peak"].append(peak)
        out["second"].append(second)
        out["mean"].append(mean)
        out["peak_ratio"].append(ratio)
        out["cn0_dbhz"].append(10.0 * np.log10(peak / max(mean, 1e-30)
                                               / code_period_s))
    return {k: np.asarray(v) for k, v in out.items()}
