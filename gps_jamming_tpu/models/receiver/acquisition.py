"""GNSS signal acquisition: batched CAF search over (PRN x Doppler x lag).

Batched re-design of `sdracq.c` + `pcorrelator` (sdrcmn.c:742-773): the
reference spawns one pthread per PRN, each sequentially evaluating 71 Doppler
rows of a 2048-lag FFT correlation and integrating 10 code periods. Here the
whole constellation is acquired in ONE batched computation: (32 PRN x 71
Doppler x 2048 lag x 10 integrations) evaluated as batched FFTs
(ops.caf/ops.fftcore), then the peak-ratio test of `checkacquisition`
(sdracq.c:52-81) vectorized over PRNs.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ...config import AcquisitionConfig, FrontendConfig
from ...ops import caf as caf_ops
from ...ops import codes as codes_ops
from ...ops import corr as corr_ops
from ...ops import cplx
from ...utils import constants as C


class AcquisitionResult(NamedTuple):
    """Per-PRN acquisition outputs (all arrays shape (n_prn,))."""
    acquired: jax.Array        # peak ratio > threshold
    code_phase: jax.Array      # samples (lag of code start in the block)
    doppler_hz: jax.Array
    peak_ratio: jax.Array
    cn0_dbhz: jax.Array
    peak_power: jax.Array


def gps_replica_table(sample_rate: float, n_samples: int) -> jax.Array:
    """conj(FFT) replicas for all 32 GPS PRNs at the capture rate."""
    return codes_ops.sampled_code_fft_conj(
        codes_ops.gps_ca_table(), C.GPS_CA_CHIP_RATE_HZ, sample_rate,
        n_samples)


def gps_replica_table_host(sample_rate: float, n_samples: int):
    """Host-precomputed planar replica table: CArray of numpy (re, im)
    planes, safe to close over in jitted kernels."""
    from ...ops import cplx
    re, im = codes_ops.sampled_code_fft_conj_host(
        codes_ops.gps_ca_table(), C.GPS_CA_CHIP_RATE_HZ, sample_rate,
        n_samples)
    return cplx.CArray(re, im)


def sbas_replica_table_host(sample_rate: float, n_samples: int):
    """Planar replica table for the 19 SBAS C/A PRNs (120..138)."""
    from ...ops import cplx
    re, im = codes_ops.sampled_code_fft_conj_host(
        codes_ops.sbas_ca_table(), C.GPS_CA_CHIP_RATE_HZ, sample_rate,
        n_samples)
    return cplx.CArray(re, im)


def acquire_all(blocks, replica_fft_conj,
                sample_rate: float, cfg: AcquisitionConfig,
                code_period_s: float = C.GPS_CA_PERIOD_S,
                code_len_chips: float = 1023.0,
                method: str = "std") -> AcquisitionResult:
    """Acquire every PRN from `n_integration` code-period blocks.

    blocks: (n_intg, n_samples) complex or CArray baseband, one code period
    each. replica_fft_conj: (n_prn, n_samples) complex or CArray.
    method: 'std' = the reference-shaped per-Doppler non-coherent search
    (sdracq.c:15-27); 'pcf' = post-correlation-FFT factorized search
    (caf.caf_accumulate_pcf) — ~4x fewer inverse DFTs, 5 ms coherent
    groups, a finer effective Doppler grid; 'auto' = pcf when its
    inverse-row count beats std for this geometry (GPS 1-ms blocks: yes;
    Galileo 4-ms blocks: no — see caf.pcf_profitable).
    """
    if method == "auto":
        n = blocks.shape[-1]
        nb = blocks.shape[-2]
        nf = caf_ops.doppler_bins(cfg.doppler_max_hz,
                                  cfg.doppler_step_hz).size
        method = "pcf" if caf_ops.pcf_profitable(
            int(n), int(nb), float(sample_rate),
            float(cfg.doppler_max_hz), int(nf)) else "std"
    if method == "pcf":
        # C/N0 normalization: the PCF surface sums blocks COHERENTLY in
        # groups of gl code periods, so peak/mean carries a factor gl the
        # non-coherent surface lacks; the effective coherent integration
        # time is gl * Tcode (peak ~ G*(gl*A)^2 vs noise ~ G*gl*sigma^2).
        gl = blocks.shape[-2] // 2
        surf = caf_ops.caf_accumulate_pcf(blocks, replica_fft_conj,
                                          sample_rate,
                                          max_doppler_hz=cfg.doppler_max_hz)
        freqs = jnp.asarray(caf_ops.pcf_doppler_hz(
            sample_rate, surf.shape[-1], cfg.doppler_max_hz))
        return acquisition_test(surf, freqs, sample_rate, cfg,
                                code_period_s * max(gl, 1),
                                code_len_chips)
    else:
        freqs = caf_ops.doppler_bins(cfg.doppler_max_hz,
                                     cfg.doppler_step_hz)
        surf = caf_ops.caf_accumulate(blocks, replica_fft_conj, freqs,
                                      sample_rate)          # (n_prn, nf, n)
        freqs = jnp.asarray(freqs)
    return acquisition_test(surf, freqs, sample_rate, cfg, code_period_s,
                            code_len_chips)


def acquisition_test(surf: jax.Array, freqs: jax.Array, sample_rate: float,
                     cfg: AcquisitionConfig, code_period_s: float,
                     code_len_chips: float = 1023.0) -> AcquisitionResult:
    """Vectorized `checkacquisition` (sdracq.c:52-81) over the PRN axis.

    Peak over (Doppler, lag); second peak and mean taken over the SAME
    Doppler row with a +/-2-chip circular exclusion window around the peak;
    C/N0 = 10*log10(peak/mean/Tcode); acquired when peak/second > threshold.
    """
    n_prn, n_freq, n = surf.shape
    nsampchip = max(int(round(n / code_len_chips)), 1)
    excl = int(cfg.exclude_chips * nsampchip)

    flat = surf.reshape(n_prn, n_freq * n)
    idx = jnp.argmax(flat, axis=-1)
    freq_i = idx // n
    code_i = idx % n
    peak = jnp.take_along_axis(flat, idx[:, None], axis=-1)[:, 0]

    rows = jnp.take_along_axis(
        surf, freq_i[:, None, None], axis=1)[:, 0, :]    # (n_prn, n)
    second = corr_ops.second_peak_excluded(rows, code_i, excl)
    mean = corr_ops.mean_excluded(rows, code_i, excl)
    ratio = peak / jnp.maximum(second, 1e-30)
    cn0 = 10.0 * jnp.log10(peak / jnp.maximum(mean, 1e-30) / code_period_s)

    return AcquisitionResult(
        acquired=ratio > cfg.peak_ratio_threshold,
        code_phase=code_i.astype(jnp.int32),
        doppler_hz=jnp.take(freqs, freq_i),
        peak_ratio=ratio,
        cn0_dbhz=cn0,
        peak_power=peak,
    )


@functools.partial(jax.jit, static_argnames=("sample_rate", "cfg",
                                             "code_period_s"))
def acquire_all_jit(blocks, replica_fft_conj, sample_rate, cfg,
                    code_period_s=C.GPS_CA_PERIOD_S):
    return acquire_all(blocks, replica_fft_conj, sample_rate, cfg,
                       code_period_s)


def refine_doppler(xp, code_table: np.ndarray, lag_samples, doppler_hz,
                   sample_rate: float, chip_rate: float,
                   carrier_hz=C.GPS_L1_FREQ_HZ, nominal_offset_hz=0.0,
                   n_blocks: int = 32, n_sub: int = 4) -> jax.Array:
    """Fine-Doppler estimate after coarse acquisition (batched, one shot).

    The coarse grid (200 Hz bins, sdr.h:64) leaves errors up to half a bin,
    but the tracking FLL's epoch-to-epoch discriminator is unambiguous
    only within +/-1/(2T) — 125 Hz for Galileo's 4 ms epochs — so a
    half-bin error can false-lock the Costas loop on a +/-k*125 Hz
    sideband (data symbols flip at every epoch boundary and absorb the
    leftover phase ramp). Standard fix: refine before handover.

    Per channel, takes `n_blocks` code periods STARTING AT THE ACQUIRED
    CODE BOUNDARY (so data-symbol edges never fall inside a period), wipes
    code + coarse carrier, splits each period into `n_sub` sub-correlations
    and averages the phase advance between adjacent sub-correlations:
    unambiguous range +/- n_sub/(2T) (+/-500 Hz at E1B), accuracy a few Hz.

    xp: CArray/complex (n,) baseband. code_table: (n_ch, code_len) host
    chips. doppler_hz: effective baseband frequency per channel (FDMA
    offset included). Returns refined doppler (n_ch,) float32.
    """
    xp = cplx.asarray(xp)
    n_ch, code_len = code_table.shape
    n_code = int(round(sample_rate * code_len / chip_rate))
    n_sub_len = n_code // n_sub
    n_win = n_blocks * n_sub * n_sub_len
    lag = jnp.asarray(lag_samples, jnp.int32)
    dopp = jnp.asarray(doppler_hz, jnp.float32)

    # contiguous per-channel windows: vmapped dynamic_slice instead of an
    # arbitrary-index gather (chosen where gathers serialized; not
    # measured on H100). The input is zero-padded by n_win so a lag near the
    # capture tail keeps its window START at the acquired code boundary
    # (dynamic_slice would otherwise clamp the start and misalign the
    # code wipe-off for the whole window); the zero tail just shortens
    # the effective integration, like the reference running out of data.
    xp = cplx.apply(
        lambda a: jnp.concatenate([a, jnp.zeros(n_win, a.dtype)]), xp)
    win = cplx.apply(
        lambda a: jax.vmap(
            lambda s: jax.lax.dynamic_slice(a, (s,), (n_win,)))(lag),
        xp)                                                 # (n_ch, n_win)
    t = jnp.arange(n_win, dtype=jnp.float32) / sample_rate
    osc = cplx.expi(-2.0 * jnp.pi * dopp[:, None] * t[None, :])
    # code Doppler scales with the TRUE carrier Doppler (FDMA offset out)
    offs = jnp.broadcast_to(jnp.asarray(nominal_offset_hz, jnp.float32),
                            (n_ch,))
    carr = jnp.broadcast_to(jnp.asarray(carrier_hz, jnp.float32), (n_ch,))
    fcode = chip_rate * (1.0 + (dopp - offs) / carr)
    chips = jax.vmap(
        lambda code, f: codes_ops.resample_code(code, f, sample_rate,
                                                n_win))(
        jnp.asarray(code_table, jnp.float32), fcode)
    mixed = cplx.scale(cplx.mul(win, osc), chips)
    z = cplx.apply(
        lambda a: jnp.sum(a.reshape(n_ch, n_blocks, n_sub, n_sub_len), -1),
        mixed)                                   # (n_ch, n_blocks, n_sub)
    za = cplx.apply(lambda a: a[..., :-1], z)
    zb = cplx.apply(lambda a: a[..., 1:], z)
    prod = cplx.mul_conj(zb, za)
    s_re = jnp.sum(prod.re, axis=(-2, -1))
    s_im = jnp.sum(prod.im, axis=(-2, -1))
    tau = n_sub_len / sample_rate
    dfreq = jnp.arctan2(s_im, s_re) / (2.0 * jnp.pi * tau)
    return (dopp + dfreq).astype(jnp.float32)
