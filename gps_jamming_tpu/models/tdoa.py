"""TDOA jammer localization: onset sync, cross-correlation, lag -> AoA,
plus multi-pair hyperbolic fusion via the CAF kernel.

Batched re-design of `skrypty/triangulateTDOA.py`:
- coarse sync by interference onset (:37-49) — ops.power.find_onset;
- cross-correlation of aligned slices (:80-89) — batched FFT xcorr over all
  antenna pairs at once (the reference does one pair in scipy);
- lag -> TDOA -> path difference -> AoA with two candidate azimuths (:92-127).

Improvements over the reference (BASELINE.md targets):
- sub-sample parabolic peak interpolation (reference: integer argmax only);
- correct baseline angle (the reference computes atan2(dy, x0-x0) — a bug
  that degenerates every baseline to +/-90 deg; we use atan2(dy, dx));
- N-antenna pairwise processing + hyperbolic least-squares position fix via
  grid search over TDOA residuals (reference stops at a single-pair bearing).
"""
from __future__ import annotations

import itertools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TdoaConfig
from ..ops import corr as corr_ops
from ..ops import cplx
from ..ops import power as power_ops
from ..utils import constants as C


class PairTdoa(NamedTuple):
    pair: tuple               # (i, j) antenna indices
    lag_samples: float        # signal_j relative to signal_i (j later > 0)
    tdoa_s: float
    path_difference_m: float
    peak_magnitude: float


def aligned_slices(iq_list: Sequence[jax.Array], cfg: TdoaConfig):
    """Onset-align each capture and cut the correlation slice
    (triangulateTDOA.py:60-83). Returns (slices CArray (n, L), onsets list);
    raises ValueError when an onset is undetectable. Captures are converted
    to planar (re, im) up front — complex dtypes never touch the device."""
    planar = [cplx.asarray(x) for x in iq_list]
    starts = []
    for x in planar:
        s = int(power_ops.find_onset(x, cfg.noise_sample_size,
                                     cfg.detection_window_size,
                                     cfg.detection_threshold_factor))
        if s < 0:
            raise ValueError("interference onset not detected")
        if x.shape[-1] < s + cfg.correlation_slice_size:
            raise ValueError("not enough samples after onset for the slice")
        starts.append(s)
    L = cfg.correlation_slice_size
    slices = cplx.stack([
        cplx.apply(lambda a, s=s: jax.lax.dynamic_slice_in_dim(a, s, L), x)
        for x, s in zip(planar, starts)])
    return slices, starts


def pair_lags(slices: jax.Array, cfg: TdoaConfig) -> jax.Array:
    """Cross-correlation peak lag for every antenna pair, batched.

    slices: (n_ant, L). Returns (n_pairs,) float lags for pairs in
    itertools.combinations order; lag computed as correlate(sig_j, sig_i)
    matching the reference's correlate(signal1, signal0).
    """
    n = slices.shape[0]
    sl = cplx.asarray(slices)
    pairs = list(itertools.combinations(range(n), 2))
    a = cplx.stack([sl[j] for (_, j) in pairs])
    b = cplx.stack([sl[i] for (i, _) in pairs])
    lag, _ = corr_ops.xcorr_peak_lag(a, b, subsample=cfg.subsample_interp)
    return lag


def bearing_from_lag(lag_samples: float, sample_rate: float,
                     ant_i_pos, ant_j_pos) -> dict:
    """Lag -> TDOA -> path difference -> two candidate azimuths
    (triangulateTDOA.py:92-127, with the baseline-angle bug fixed)."""
    tdoa = lag_samples / sample_rate
    path_diff = tdoa * C.SPEED_OF_LIGHT
    pi = np.asarray(ant_i_pos, dtype=np.float64)
    pj = np.asarray(ant_j_pos, dtype=np.float64)
    baseline = float(np.linalg.norm(pj - pi))
    out = {"tdoa_s": float(tdoa), "path_difference_m": float(path_diff),
           "baseline_m": baseline, "valid": False,
           "theta_deg": None, "azimuths_deg": None}
    if baseline == 0.0:
        return out
    cos_arg = path_diff / baseline
    if abs(cos_arg) > 1.0:
        return out   # reference warns: likely config error or multipath
    theta = float(np.degrees(np.arccos(cos_arg)))
    base_ang = float(np.degrees(np.arctan2(pj[1] - pi[1], pj[0] - pi[0])))
    out.update(valid=True, theta_deg=theta,
               azimuths_deg=((base_ang + theta) % 360.0,
                             (base_ang - theta) % 360.0))
    return out


def hyperbolic_grid_fix(antenna_positions_m: Sequence, pair_ids: Sequence,
                        path_diffs_m: Sequence, span_m: float = 50.0,
                        density: int = 512) -> np.ndarray:
    """Least-squares source position from pairwise path differences.

    Grid search minimizing sum over pairs of
    | (|p - ant_j| - |p - ant_i|) - measured_path_diff |   — the hyperbolic
    multilateration the reference lacks. Pure broadcast, one jitted eval.
    """
    pos = jnp.asarray(antenna_positions_m, jnp.float32)
    center = jnp.mean(pos, axis=0)
    xs = jnp.linspace(center[0] - span_m, center[0] + span_m, density)
    ys = jnp.linspace(center[1] - span_m, center[1] + span_m, density)
    gx = xs[None, :, None]
    gy = ys[:, None, None]
    d = jnp.sqrt((gx - pos[:, 0]) ** 2 + (gy - pos[:, 1]) ** 2)  # (g,g,n_ant)
    err = jnp.zeros(d.shape[:2], jnp.float32)
    for (i, j), pd in zip(pair_ids, path_diffs_m):
        err = err + jnp.abs((d[..., j] - d[..., i]) - pd)
    idx = jnp.argmin(err)
    iy, ix = idx // density, idx % density
    return np.asarray(jnp.stack([xs[ix], ys[iy]]))


def file_onset(path: str, cfg: TdoaConfig,
               chunk_samples: int = 1 << 21) -> int:
    """Bounded-memory interference-onset search over a capture FILE.

    Same DETECTION contract as ops.power.find_onset
    (triangulateTDOA.py:37-49) — but the streamed moving average
    accumulates in float64, so on multi-minute captures (where the
    device path's float32 cumsum loses precision) this path is the MORE
    accurate of the two; near-threshold crossings can differ by a
    sample. Contract details:
    noise floor = mean power of the first noise_sample_size samples,
    onset = first index whose window moving average exceeds
    factor * floor, recentered by window//2; -1 when never crossed.
    Host memory = one chunk (+ window carry)."""
    from ..ops import iq as iq_ops

    x0 = iq_ops.read_iq_file(path, convention="centered",
                             count=2 * cfg.noise_sample_size)
    if x0.size == 0:
        return -1
    p0 = (x0.real.astype(np.float32) ** 2 + x0.imag.astype(np.float32) ** 2)
    noise = float(np.mean(p0)) or 1e-9
    thr = noise * cfg.detection_threshold_factor
    w = cfg.detection_window_size

    carry = np.zeros(0, np.float64)
    g0 = 0                                # global index of carry[0]
    read_at = 0
    while True:
        x = iq_ops.read_iq_file(path, convention="centered",
                                count=2 * chunk_samples,
                                offset_bytes=2 * read_at)
        if x.size == 0:
            return -1
        read_at += x.size
        pw = (x.real.astype(np.float32) ** 2
              + x.imag.astype(np.float32) ** 2).astype(np.float64)
        seq = np.concatenate([carry, pw])
        if seq.size >= w:
            c = np.concatenate([[0.0], np.cumsum(seq)])
            avg = (c[w:] - c[:-w]) / w
            above = avg > thr
            if above.any():
                return g0 + int(np.argmax(above)) + w // 2
            keep = w - 1
            g0 += seq.size - keep
            carry = seq[-keep:]
        else:
            carry = seq


def localize_files(paths: Sequence[str], antenna_positions_m: Sequence,
                   sample_rate: float,
                   cfg: TdoaConfig = TdoaConfig()) -> dict:
    """`localize` fed from capture FILES with bounded host memory: the
    onset scan streams chunks and only the correlation slices
    (50 000 samples each, triangulateTDOA.py:80-83) are read in full."""
    from ..ops import iq as iq_ops

    starts = []
    slices_np = []
    L = cfg.correlation_slice_size
    for p in paths:
        s0 = file_onset(p, cfg)
        if s0 < 0:
            raise ValueError("interference onset not detected")
        sl = iq_ops.read_iq_file(p, convention="centered",
                                 count=2 * L, offset_bytes=2 * s0)
        if sl.size < L:
            raise ValueError("not enough samples after onset for the slice")
        starts.append(s0)
        slices_np.append(sl)
    slices = cplx.stack([cplx.from_complex(jnp.asarray(sl))
                         for sl in slices_np])
    return _localize_from_slices(slices, starts, len(paths),
                                 antenna_positions_m, sample_rate, cfg)


def localize(iq_list: Sequence[jax.Array], antenna_positions_m: Sequence,
             sample_rate: float, cfg: TdoaConfig = TdoaConfig()) -> dict:
    """Full TDOA pipeline over N >= 2 antennas.

    Returns per-pair results (reference-compatible bearings) plus, with
    N >= 3, a hyperbolic grid position fix.
    """
    slices, onsets = aligned_slices(iq_list, cfg)
    return _localize_from_slices(slices, onsets, len(iq_list),
                                 antenna_positions_m, sample_rate, cfg)


def _localize_from_slices(slices, onsets, n_ant, antenna_positions_m,
                          sample_rate, cfg) -> dict:
    lags = np.asarray(pair_lags(slices, cfg))
    pairs = list(itertools.combinations(range(n_ant), 2))

    results = []
    path_diffs = []
    for (i, j), lag in zip(pairs, lags):
        r = bearing_from_lag(float(lag), sample_rate,
                             antenna_positions_m[i], antenna_positions_m[j])
        r["pair"] = (i, j)
        r["lag_samples"] = float(lag)
        results.append(r)
        path_diffs.append(r["path_difference_m"])

    out = {"onsets": onsets, "pairs": results, "position_m": None}
    if n_ant >= 3:
        fix = hyperbolic_grid_fix(antenna_positions_m, pairs, path_diffs)
        out["position_m"] = [float(fix[0]), float(fix[1])]
    return out
