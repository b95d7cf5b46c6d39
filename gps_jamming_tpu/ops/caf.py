"""Cross-ambiguity function (CAF): delay x Doppler correlation surfaces.

The flagship batched kernel of the framework. Generalizes the reference's
acquisition correlator (`pcorrelator` + `cpxconv`, sdrcmn.c:124-147/:742-773),
which evaluates one (Doppler, all-lags) row at a time per channel thread, into
a single batched computation over (channel/PRN x Doppler x lag) that XLA maps
onto large batched FFTs (cuFFT on the GPU).

Two flavours:
- `caf_surface`: signal vs precomputed replica FFT (GNSS acquisition).
- `caf_pair`: signal vs signal (TDOA/FDOA between antenna pairs) — a
  capability the reference only approximates with zero-Doppler xcorr.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import cplx, fftcore


def doppler_bins(max_hz: float, step_hz: float) -> np.ndarray:
    """Symmetric Doppler grid, matching sdrinit.c:182-185 (71 bins default)."""
    n = int(round(2 * max_hz / step_hz)) + 1
    return (np.arange(n) * step_hz - max_hz).astype(np.float32)


def _doppler_mix_p(x: cplx.CArray, freqs: jax.Array,
                   sample_rate: float) -> cplx.CArray:
    """Mix x down by each Doppler bin: out[f, n] = x[n] * e^{-j 2 pi f n Ts}.

    x: (..., n) -> (..., n_freq, n). The phasor table is built once per shape
    under jit and fused into the FFT input.
    """
    n = x.shape[-1]
    t = jnp.arange(n, dtype=jnp.float32) / sample_rate
    phase = -2.0 * jnp.pi * freqs[:, None] * t[None, :]
    osc = cplx.expi(phase)
    return cplx.mul(cplx.apply(lambda a: a[..., None, :], x), osc)


def caf_surface(x, replica_fft_conj, freqs: jax.Array,
                sample_rate: float) -> jax.Array:
    """CAF power surface of a signal block against code replicas.

    Args:
      x: (n,) or (batch, n) complex (or CArray) baseband block.
      replica_fft_conj: (n_code, n) conj(FFT(replica)) per code (PRN),
        complex or CArray.
      freqs: (n_freq,) Doppler bins [Hz].
      sample_rate: [Hz].

    Returns float32 (..., n_code, n_freq, n) power: one circular-lag row per
    (code, Doppler).
    """
    x = cplx.asarray(x)
    rep = replica_fft_conj if isinstance(replica_fft_conj, cplx.CArray) \
        else cplx.asarray(replica_fft_conj)
    mixed = _doppler_mix_p(x, freqs, sample_rate)        # (..., n_freq, n)
    mf = fftcore.fft_p(mixed)
    prod = cplx.mul(cplx.apply(lambda a: a[..., None, :, :], mf),
                    cplx.apply(lambda a: a[:, None, :], rep))
    return fftcore.ifft_power_p(prod)


def caf_accumulate(blocks, replica_fft_conj, freqs,
                   sample_rate: float) -> jax.Array:
    """Non-coherent accumulation of CAF power over integration blocks.

    blocks: (n_blocks, n). Equivalent to the reference's `intg`-fold
    accumulation loop in `sdraqcuisition` (sdracq.c:15-27) but evaluated as
    one batched op and summed.
    """
    p = caf_surface(blocks, replica_fft_conj, freqs, sample_rate)
    return jnp.sum(p, axis=0)


# ---------------------------------------------------------------------------
# Post-correlation-FFT (PCF) acquisition: same (PRN x Doppler x lag) search
# at ~4x fewer inverse DFTs than the block-per-Doppler formulation.
# ---------------------------------------------------------------------------

def pcf_doppler_hz(sample_rate: float, n: int, max_doppler_hz: float,
                   n_sets: int = 2,
                   fine_hz=(-200.0, 0.0, 200.0)) -> np.ndarray:
    """The (n_coarse * n_sets * n_fine,) Doppler grid of caf_accumulate_pcf,
    ordered (coarse, set, fine) to match the surface's Doppler axis."""
    bin_hz = sample_rate / n
    n_c = 2 * int(np.floor(max_doppler_hz / bin_hz)) + 1
    cvals = (np.arange(n_c) - n_c // 2) * bin_hz
    sets = np.arange(n_sets) * (bin_hz / n_sets)
    fine = np.asarray(fine_hz, np.float64)
    d = (cvals[:, None, None] + sets[None, :, None] + fine[None, None, :])
    return d.reshape(-1).astype(np.float32)


def pcf_profitable(n: int, n_blocks: int, sample_rate: float,
                   max_doppler_hz: float, n_freq_std: int,
                   n_sets: int = 2, n_fine: int = 3,
                   n_groups: int = 2) -> bool:
    """Does the PCF factorization beat the per-Doppler search for this
    geometry?

    PCF wins when the FFT bin spacing fs/n is COARSE relative to the
    Doppler span (GPS: 1 kHz bins, 15 coarse shifts replace 71 bins).
    For long blocks the bins are already fine (Galileo E1B 16k @ 4 ms:
    250 Hz) and the coarse axis balloons (57 bins x sets x fine x groups
    = 684 rows vs 71 x 10 blocks = 710): there the two are close. The
    rule compares inverse-DFT row counts, the dominant cost either way.
    """
    bin_hz = sample_rate / n
    n_c = 2 * int(np.floor(max_doppler_hz / bin_hz)) + 1
    pcf_rows = n_c * n_sets * n_fine * n_groups
    std_rows = n_freq_std * n_blocks
    return pcf_rows < std_rows


def caf_accumulate_pcf(blocks, replica_fft_conj, sample_rate: float,
                       max_doppler_hz: float = 7000.0, n_sets: int = 2,
                       fine_hz=(-200.0, 0.0, 200.0),
                       n_groups: int = 2) -> jax.Array:
    """Acquisition surface via post-correlation Doppler factorization.

    The classic formulation (`caf_accumulate`) runs one forward+inverse
    DFT pipeline per (Doppler bin x block): 71 x 10 for the GPS search.
    This factorizes the Doppler axis into
      coarse  = integer FFT-bin shifts (fs/n = 1 kHz at GPS 2048):
                applied as circular shifts of the REPLICA spectrum — zero
                extra transforms (the shift phase falls out of |.|^2);
      sets    = n_sets sub-bin offsets (500 Hz): the only extra forward
                mixes, n_sets*n_blocks forward FFTs total;
      fine    = a tiny DFT across the block axis (post-correlation FFT,
                applied pre-inverse since the replica product commutes
                with the cross-block sum).
    Blocks are summed COHERENTLY inside n_groups groups (5 ms at GPS),
    then group powers add non-coherently — so a data-symbol edge can
    degrade at most one group (IS-GPS-200 20 ms bits). Inverse-DFT count
    drops from n_freq*n_blocks (710) to n_coarse*n_sets*n_fine*n_groups
    (180 at the default grid) while the effective Doppler grid is FINER
    than the reference's 200 Hz (max 50 Hz bias vs 100 Hz) and 5 ms
    coherent integration GAINS sensitivity over the reference's 10 x 1 ms
    non-coherent sum (sdracq.c:15-27).

    blocks: (n_blocks, n) one code period each; n_blocks % n_groups == 0.
    Returns float32 (n_prn, n_coarse*n_sets*n_fine, n); the Doppler value
    of axis-1 index i is pcf_doppler_hz(...)[i].
    """
    x = cplx.asarray(blocks)
    rep = replica_fft_conj if isinstance(replica_fft_conj, cplx.CArray) \
        else cplx.asarray(replica_fft_conj)
    nb, n = x.shape[-2], x.shape[-1]
    if nb % n_groups:
        raise ValueError(f"n_blocks {nb} not divisible by {n_groups} groups")
    gl = nb // n_groups
    bin_hz = sample_rate / n
    set_off = bin_hz / n_sets
    n_c = 2 * int(np.floor(max_doppler_hz / bin_hz)) + 1
    cvals = np.arange(n_c) - n_c // 2
    fine = np.asarray(fine_hz, np.float64)
    t_block = n / sample_rate

    # 1. per-set sub-bin mixes (local time) + forward FFTs
    t = jnp.arange(n, dtype=jnp.float32) / sample_rate
    sets = jnp.arange(n_sets, dtype=jnp.float32) * set_off
    osc = cplx.expi(-2.0 * jnp.pi * sets[:, None, None]
                    * t[None, None, :])                  # (S, 1, n)
    mixed = cplx.mul(cplx.apply(lambda a: a[None, :, :], x), osc)
    mf = fftcore.fft_p(mixed)                            # (S, B, n)

    # 2. cross-block fine DFT inside each coherent group. The inter-block
    # phase of the set offset (set_off*T = 1/2 cycle per block) is folded
    # into the weights; the coarse shift needs none (bin_hz*T = 1 cycle).
    b_idx = np.arange(nb, dtype=np.float64)
    wf = fine[None, :, None] + (np.arange(n_sets, dtype=np.float64)
                                * set_off)[:, None, None]  # (S, F, 1)
    phase = -2.0 * np.pi * wf * (b_idx * t_block)[None, None, :]
    w_re = np.cos(phase).astype(np.float32)              # (S, F, B)
    w_im = np.sin(phase).astype(np.float32)
    grp = np.zeros((n_groups, nb), np.float32)
    for g in range(n_groups):
        grp[g, g * gl:(g + 1) * gl] = 1.0
    wg_re = jnp.asarray(w_re[:, :, None, :] * grp[None, None, :, :])
    wg_im = jnp.asarray(w_im[:, :, None, :] * grp[None, None, :, :])
    # S_sum[s,f,g,k] = sum_b w[s,f,g,b] * mf[s,b,k]
    s_re = (jnp.einsum("sfgb,sbk->sfgk", wg_re, mf.re)
            - jnp.einsum("sfgb,sbk->sfgk", wg_im, mf.im))
    s_im = (jnp.einsum("sfgb,sbk->sfgk", wg_re, mf.im)
            + jnp.einsum("sfgb,sbk->sfgk", wg_im, mf.re))
    S = cplx.CArray(s_re, s_im)                          # (S, F, G, n)

    # 3. coarse shifts. Shifting the replica spectrum by c bins,
    # rep[p, (k-c) % n] * S[k], is the product rep[p, k] * S[(k+c) % n]
    # rotated by c bins, whose inverse DFT differs by a phase ramp that
    # |.|^2 removes. So the shift is taken on S, which is traced and small,
    # and not on the replica table: a shifted host-constant table is folded
    # into the executable by XLA (269 MB for Galileo E1B's 16384 lags).
    k_idx = (np.arange(n)[None, :] + cvals[:, None]) % n   # (C, n)
    Sc = cplx.apply(lambda a: jnp.moveaxis(
        jnp.take(a, jnp.asarray(k_idx), axis=-1), -2, 0), S)  # (C,S,F,G,n)

    # 4. product -> inverse -> |.|^2 -> non-coherent sum over groups
    prod = cplx.mul(
        cplx.apply(lambda a: jnp.asarray(a)[:, None, None, None, None, :],
                   rep),
        cplx.apply(lambda a: a[None], Sc))
    pwr = fftcore.ifft_power_p(prod)        # (P, C, S, F, G, n)
    surf = jnp.sum(pwr, axis=-2)            # (P, C, S, F, n)
    n_prn = surf.shape[0]
    return surf.reshape(n_prn, n_c * n_sets * fine.size, n)


def caf_accumulate_pcf_fdma(blocks, replica_fft_conj, offsets_hz,
                            sample_rate: float,
                            max_doppler_hz: float = 7000.0,
                            n_sets: int = 2,
                            fine_hz=(-200.0, 0.0, 200.0),
                            n_groups: int = 2) -> jax.Array:
    """PCF-factorized acquisition over FDMA channels sharing ONE code.

    The GLONASS G1 search (glonass.acquire_all) is (14 channels x 71
    Doppler x n lags): the direct formulation mixes 994 frequency rows of
    the full block set (a ~(B, 994, n) complex intermediate — gigabytes
    of HBM traffic at n = 10000). This factorization mixes only
    (channel-sub-bin x set) rows and rides the rest on integer FFT-bin
    shifts of the SHARED replica spectrum:

      offset_c = coarse_c * bin + sub_c   (bin = fs/n, sub_c in [0, bin))
      mix rows = e^{-j 2 pi (sub_c + s*bin/n_sets) t}      (C x S x B
                 forward FFTs — 280 vs 9940 for the direct form)
      coarse   = replica shifted by (coarse_c + d), d in [-D..D]
                 (D = floor(max_doppler/bin); the shift phase falls out
                 of |.|^2)
      fine     = cross-block DFT inside each of n_groups coherent groups
                 (5 ms coherent at 1 ms codes — MORE sensitive than the
                 reference's 10x1 ms non-coherent sum, sdracq.c:15-27)

    blocks: (n_blocks, n), one code period each. replica_fft_conj:
    (1, n) conj(FFT(replica)) CArray. offsets_hz: (n_ch,) static FDMA
    offsets. Returns (n_ch, n_coarse*n_sets*n_fine, n) float32; the
    Doppler of axis-1 index i RELATIVE TO THE CHANNEL CARRIER is
    pcf_doppler_hz(sample_rate, n, max_doppler_hz, n_sets, fine_hz)[i]
    (sub_c is wiped exactly by the mix; set/fine carry the same <=50 Hz
    interior within-block bias as the GPS PCF search).
    """
    x = cplx.asarray(blocks)
    rep = replica_fft_conj if isinstance(replica_fft_conj, cplx.CArray) \
        else cplx.asarray(replica_fft_conj)
    nb, n = x.shape[-2], x.shape[-1]
    if nb % n_groups:
        raise ValueError(f"n_blocks {nb} not divisible by {n_groups}")
    gl = nb // n_groups
    bin_hz = sample_rate / n
    set_off = bin_hz / n_sets
    offs = np.asarray(offsets_hz, np.float64).reshape(-1)
    n_ch = offs.size
    coarse_c = np.floor(offs / bin_hz).astype(np.int64)
    sub_c = offs - coarse_c * bin_hz                     # [0, bin)
    D = int(np.floor(max_doppler_hz / bin_hz))
    dvals = np.arange(-D, D + 1)
    n_c = dvals.size
    fine = np.asarray(fine_hz, np.float64)
    nF = fine.size
    t_block = n / sample_rate

    # 1. (channel-sub-bin x set) mixes + forward FFTs: (C, S, B, n)
    t = jnp.arange(n, dtype=jnp.float32) / np.float32(sample_rate)
    mix_f = (sub_c[:, None] + np.arange(n_sets)[None, :] * set_off)
    osc = cplx.expi(-2.0 * jnp.pi
                    * jnp.asarray(mix_f.astype(np.float32))[:, :, None,
                                                            None]
                    * t[None, None, None, :])
    mixed = cplx.mul(cplx.apply(lambda a: a[None, None], x), osc)
    mf = fftcore.fft_p(mixed)                            # (C, S, B, n)

    # 2. cross-block fine DFT inside coherent groups: the inter-block
    # phase of the mix row (sub_c + s*set_off per block period) must be
    # folded into the weights (it does NOT fall out of |.|^2 because the
    # group sum is coherent); the coarse replica shift needs none.
    b_idx = np.arange(nb, dtype=np.float64)
    wf = (fine[None, None, :] + mix_f[:, :, None])       # (C, S, F)
    phase = -2.0 * np.pi * wf[..., None] * (b_idx * t_block)
    w_re = np.cos(phase).astype(np.float32)              # (C, S, F, B)
    w_im = np.sin(phase).astype(np.float32)
    grp = np.zeros((n_groups, nb), np.float32)
    for g in range(n_groups):
        grp[g, g * gl:(g + 1) * gl] = 1.0
    wg_re = jnp.asarray(w_re[..., None, :] * grp)        # (C,S,F,G,B)
    wg_im = jnp.asarray(w_im[..., None, :] * grp)
    s_re = (jnp.einsum("csfgb,csbk->csfgk", wg_re, mf.re)
            - jnp.einsum("csfgb,csbk->csfgk", wg_im, mf.im))
    s_im = (jnp.einsum("csfgb,csbk->csfgk", wg_re, mf.im)
            + jnp.einsum("csfgb,csbk->csfgk", wg_im, mf.re))
    S = cplx.CArray(s_re, s_im)                          # (C,S,F,G,n)

    # 3. per-channel coarse shifts of the shared replica spectrum:
    # repc[c, d, k] = rep[(k - (coarse_c + d)) mod n]  — host constant
    shift = (coarse_c[:, None] + dvals[None, :])         # (C, n_c)
    k_idx = (np.arange(n)[None, None, :] - shift[..., None]) % n
    rep_re = np.asarray(rep.re, np.float32).reshape(n)
    rep_im = np.asarray(rep.im, np.float32).reshape(n)
    repc = cplx.CArray(jnp.asarray(rep_re[k_idx]),
                       jnp.asarray(rep_im[k_idx]))       # (C, n_c, n)

    # 4. product -> inverse -> |.|^2 -> non-coherent group sum
    prod = cplx.mul(
        cplx.apply(lambda a: a[:, :, None, None, None, :], repc),
        cplx.apply(lambda a: a[:, None], S))             # (C,nc,S,F,G,n)
    pwr = fftcore.ifft_power_p(prod)
    surf = jnp.sum(pwr, axis=-2)                         # (C,nc,S,F,n)
    return surf.reshape(n_ch, n_c * n_sets * nF, n)


def caf_pair(a, b, freqs: jax.Array, sample_rate: float) -> jax.Array:
    """Signal-vs-signal CAF (delay x Doppler) for one antenna pair.

    out[f] = |IFFT(FFT(a * e^{-j2 pi f t}) * conj(FFT(b)))|^2 over circular
    lags. Zero-padding to 2*n makes lags linear within +/- n.
    Returns (n_freq, 2n) float32.
    """
    a = cplx.asarray(a)
    b = cplx.asarray(b)
    n = a.shape[-1]
    nfft = 2 * n
    mixed = _doppler_mix_p(a, freqs, sample_rate)
    af = fftcore.fft_p(mixed, n=nfft)
    bf = fftcore.fft_p(b, n=nfft)
    prod = cplx.mul_conj(af, cplx.apply(lambda v: v[..., None, :], bf))
    return fftcore.ifft_power_p(prod)


def caf_peak(power: jax.Array, n_code_axis: int = -1):
    """Peak location over a (n_freq, n_lag) CAF surface.

    Returns (freq_idx, lag_idx, peak_val) as traced scalars.
    """
    nf, nl = power.shape[-2], power.shape[-1]
    flat = power.reshape(power.shape[:-2] + (nf * nl,))
    idx = jnp.argmax(flat, axis=-1)
    return idx // nl, idx % nl, jnp.take_along_axis(flat, idx[..., None], -1)[..., 0]
