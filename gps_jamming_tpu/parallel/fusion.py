"""Sharded multi-antenna processing pipelines.

The multi-chip formulation of the detection/localization chain (SURVEY.md
§2.3, BASELINE.json configs 4-5): captures laid out as
(n_antenna, n_blocks, block_len) over a ('antenna', 'time') mesh, with

- per-shard Welch PSD with overlap-save halos across time shards
  (halo.halo_from_next), averaged over time via psum -> identical to the
  unsharded PSD of the whole stream;
- per-shard chunk power maps, all-gathered along time to form the full-file
  F1 power profile;
- PSD fusion across antennas via psum (mean) — replacing the reference's
  HTTP fan-in of per-receiver telemetry (sdrout.c:10-57) with a device
  collective.

All entry points are shard_map-under-jit over an explicit Mesh, and the
device math is planar-complex (ops.cplx.CArray) through ops.fftcore — the
same FFT path as the single-device kernels. Complex inputs are split into
(re, im) planes at the host edge.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..config import DetectorConfig, SpectralConfig
from ..ops import cplx, fftcore
from ..ops import power as power_ops
from ..ops import spectral
from ..ops.iq import frame, remove_dc
from . import halo
from .mesh import ANTENNA_AXIS, TIME_AXIS


def _welch_partial(block: cplx.CArray, sample_rate, nperseg, overlap_frac):
    """Per-shard Welch: segment sum + count (so shard means combine exactly).

    Welch with hop h over a block of length L yields 1+(L-nperseg)//h
    segments; the halo keeps boundary-straddling segments. We return the sum
    of per-segment periodograms and the segment count for exact combination.
    """
    hop = int(nperseg * (1.0 - overlap_frac))
    win = jnp.asarray(spectral._hann(nperseg))
    segs = cplx.apply(lambda a: frame(a, nperseg, hop), block)
    segs = cplx.apply(lambda a: remove_dc(a, axis=-1), segs)
    segs = cplx.CArray(segs.re * win, segs.im * win)
    p = fftcore.fft_power_p(segs)
    scale = 1.0 / (sample_rate * jnp.sum(win * win))
    return jnp.sum(p, axis=-2) * scale, p.shape[-2]


def sharded_psd_and_power(blocks, mesh, sample_rate: float,
                          det_cfg: DetectorConfig,
                          spec_cfg: SpectralConfig):
    """Fused sharded pipeline over a (n_antenna, n_blocks, block_len) capture.

    `blocks` may be a complex array (split to planes at the host edge) or a
    planar cplx.CArray of (re, im) float32 planes.

    Returns:
      psd_fused: (nperseg,) antenna-mean, time-mean Welch PSD (replicated);
      psd_per_antenna: (n_antenna, nperseg);
      power_map: (n_antenna, total_chunks) full F1 chunk power profile.
    """
    nperseg = spec_cfg.nperseg
    hop = int(nperseg * (1.0 - spec_cfg.overlap_frac))
    chunk = det_cfg.power_chunk_samples
    xp = cplx.asarray(blocks)

    def kernel(local: cplx.CArray):          # local: (1, blocks/shard, L)
        x = local.reshape(local.shape[0], -1)          # concat local blocks
        # --- PSD with halo so segments straddling shard edges are kept ---
        xh = cplx.apply(
            lambda a: halo.halo_from_next(a, nperseg - hop), x)
        psum_seg, nseg = _welch_partial(xh, sample_rate, nperseg,
                                        spec_cfg.overlap_frac)
        # drop the zero-padded tail contribution on the LAST shard: its halo
        # is zeros, matching the unsharded stream's end (no extra segments
        # exist there). Number of valid segments on last shard:
        t_idx = jax.lax.axis_index(TIME_AXIS)
        n_time = jax.lax.axis_size(TIME_AXIS)
        L = x.shape[-1]
        nseg_last = 1 + (L - nperseg) // hop
        # recompute PSD sum without halo for the last shard
        psum_nohalo, _ = _welch_partial(x, sample_rate, nperseg,
                                        spec_cfg.overlap_frac)
        is_last = t_idx == n_time - 1
        seg_sum = jnp.where(is_last, psum_nohalo, psum_seg)
        seg_cnt = jnp.where(is_last, nseg_last, nseg).astype(jnp.float32)

        tot_sum = jax.lax.psum(seg_sum, TIME_AXIS)
        tot_cnt = jax.lax.psum(seg_cnt, TIME_AXIS)
        psd_ant = tot_sum / tot_cnt                    # (1, nperseg)
        # fuse across antennas (mean)
        n_ant = jax.lax.axis_size(ANTENNA_AXIS)
        psd_fused = (jax.lax.psum(psd_ant, ANTENNA_AXIS) / n_ant)[0]

        # --- chunk power profile, gathered along time ---
        pm_local = power_ops.chunk_power_p(x, chunk)   # (1, chunks/shard)
        pm_full = jax.lax.all_gather(pm_local, TIME_AXIS, axis=-1, tiled=True)
        return psd_fused, psd_ant, pm_full

    f = jax.shard_map(
        kernel, mesh=mesh,
        in_specs=P(ANTENNA_AXIS, TIME_AXIS, None),
        out_specs=(P(), P(ANTENNA_AXIS, None), P(ANTENNA_AXIS, None)),
        check_vma=False,
    )
    psd_fused, psd_ant, pm = jax.jit(f)(xp)
    return psd_fused, psd_ant, pm


def sharded_caf_acquire(blocks, mesh, replica_fft_conj: cplx.CArray,
                        doppler_hz: np.ndarray, sample_rate: float, *,
                        method: str = "std",
                        max_doppler_hz: float = 7000.0,
                        group_blocks: int | None = None):
    """Sharded non-coherent CAF acquisition over an ('antenna','time') mesh.

    The multi-chip form of the acquisition search (the reference's
    `sdraqcuisition` intg-fold loop, sdracq.c:15-27): each time shard
    accumulates CAF power over its local integration blocks, `psum`
    along TIME completes the
    non-coherent integration, and `all_gather` along ANTENNA exposes every
    antenna's surface on every device — the collective that replaces the
    reference's per-receiver HTTP fan-in (worker.py:567-611 + sdrout.c:10-57)
    for multi-antenna acquisition/TDOA fusion.

    method:
      'std' — `ops.caf.caf_accumulate`, one row per (Doppler bin x block)
        over the explicit `doppler_hz` grid; blocks sum non-coherently, so
        any time split is exact.
      'pcf' — the shipping post-correlation-FFT factorized search
        (`ops.caf.caf_accumulate_pcf`, the single-chip default since r3).
        COHERENT-GROUP BOUNDARY CONTRACT: blocks inside one coherent
        group (length `group_blocks`) must live on ONE time shard — the
        group's coherent sum picks up a shard-local index phase
        e^(j*2*pi*f*b0*T) which cancels in |.|^2 only if the whole group
        is local. Each shard therefore computes whole-group powers
        (n_groups_local = blocks_local / group_blocks) and `psum` along
        TIME adds the NON-coherent group powers, exactly reproducing the
        single-device surface. `group_blocks` must divide every shard's
        local block count (default: all local blocks = one group per
        shard); `doppler_hz` is ignored — the axis is
        `ops.caf.pcf_doppler_hz(sample_rate, n_code, max_doppler_hz)`.

    Args:
      blocks: (n_antenna, n_time_shards, block_len) complex or planar
        CArray; block_len must be a multiple of the replica length (each
        code period is one integration block).
      mesh: ('antenna', 'time') Mesh (parallel.mesh.make_mesh).
      replica_fft_conj: (n_prn, n_code) conj(FFT(replica)) CArray.
      doppler_hz: (n_freq,) numpy Doppler bins (method='std' only).

    Returns float32 (n_antenna, n_prn, n_freq, n_code), replicated across
    the mesh.
    """
    xp = cplx.asarray(blocks)
    replica_fft_conj = cplx.asarray(replica_fft_conj)
    n_code = replica_fft_conj.re.shape[-1]
    if xp.shape[-1] % n_code:
        raise ValueError(f"block_len {xp.shape[-1]} not a multiple of the "
                         f"replica length {n_code}")
    gb = ((xp.shape[-1] // n_code) if group_blocks is None
          else int(group_blocks))

    def kernel(local: cplx.CArray):        # local: (1, shards_local, L)
        x2 = local.reshape(-1, n_code)     # integration blocks on this shard
        from ..ops import caf as caf_ops
        if method == "pcf":
            if x2.shape[0] % gb:           # static shape: trace-time check
                raise ValueError(
                    f"group_blocks {gb} must divide the {x2.shape[0]} "
                    f"integration blocks on each time shard (coherent "
                    f"groups cannot straddle shard boundaries)")
            surf = caf_ops.caf_accumulate_pcf(
                x2, replica_fft_conj, sample_rate,
                max_doppler_hz=max_doppler_hz,
                n_groups=x2.shape[0] // gb)
        else:
            surf = caf_ops.caf_accumulate(x2, replica_fft_conj, doppler_hz,
                                          sample_rate)
        surf = jax.lax.psum(surf, TIME_AXIS)           # (n_prn, nf, n_code)
        return jax.lax.all_gather(surf, ANTENNA_AXIS)  # (n_ant, ...)

    f = jax.shard_map(kernel, mesh=mesh,
                      in_specs=P(ANTENNA_AXIS, TIME_AXIS, None),
                      out_specs=P(), check_vma=False)
    return jax.jit(f)(xp)


def sharded_pair_xcorr(slices, mesh, nfft: int | None = None):
    """All-pairs FFT cross-correlation with antenna-sharded inputs.

    The TDOA fusion path on a mesh: per-antenna aligned slices live
    sharded along ANTENNA; one `all_gather` makes the full
    antenna set local, then every device evaluates the batched
    freq-domain correlation r_ij = IFFT(FFT(a_i) * conj(FFT(a_j))) for
    all i<j pairs (models/tdoa.py `pair_lags` math, zero-padded to 2L so
    lags are linear within +/-L). Replaces the reference's
    file-per-antenna loop (triangulateTDOA.py:80-89) with one collective
    + one batched FFT.

    Args:
      slices: (n_antenna, L) complex or planar CArray, sharded on axis 0.
      nfft: FFT length (default 2L).

    Returns float32 (n_pairs, nfft) |xcorr|^2, replicated; pair order =
    itertools.combinations(range(n_antenna), 2).
    """
    xp = cplx.asarray(slices)
    n_ant = xp.shape[0]
    L = xp.shape[-1]
    nfft = nfft or 2 * L
    import itertools
    ii, jj = map(np.array, zip(*itertools.combinations(range(n_ant), 2)))

    def kernel(local: cplx.CArray):        # (n_ant/shard, L)
        full = cplx.apply(
            lambda a: jax.lax.all_gather(a, ANTENNA_AXIS, axis=0,
                                         tiled=True), local)
        F = fftcore.fft_p(full, n=nfft)     # (n_ant, nfft)
        a = cplx.apply(lambda v: v[ii], F)
        b = cplx.apply(lambda v: v[jj], F)
        return fftcore.ifft_power_p(cplx.mul_conj(a, b))

    f = jax.shard_map(kernel, mesh=mesh,
                      in_specs=P(ANTENNA_AXIS, None),
                      out_specs=P(), check_vma=False)
    return jax.jit(f)(xp)


def shard_blocks(iq: np.ndarray, n_antenna: int, n_time: int,
                 block_len: int | None = None) -> np.ndarray:
    """Host-side layout: (n_antenna, n_time_blocks, block_len) from per-
    antenna streams; pads the tail with zeros."""
    x = np.asarray(iq)
    if x.ndim == 1:
        x = x[None, :]
    assert x.shape[0] == n_antenna
    n = x.shape[-1]
    if block_len is None:
        block_len = -(-n // n_time)
    total = n_time * block_len
    if total > n:
        x = np.pad(x, ((0, 0), (0, total - n)))
    return x[:, :total].reshape(n_antenna, n_time, block_len)
