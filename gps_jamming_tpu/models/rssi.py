"""RSSI path-loss ranging + grid-search jammer localization.

Batched re-design of `skrypty/triangulateRSSI.py` (+ the heatmap variant
`triangulateRSSIplot.py` and the single-antenna `CalculateDistance.py`):

- per-antenna ranging: turn-on detection -> mean amplitude -> received power
  -> log-distance inversion (triangulateRSSI.py:54-82) as one jitted kernel;
- localization: the 300x300 error-surface grid search (:88-120) is a pure
  broadcast — evaluated on-device in one shot (the reference loops in
  Python/NumPy). The default grid matches the reference for parity; the
  device has headroom for much denser grids (see `grid_search` density arg);
- heatmap variant: full error surface + top-k distinct local minima >= 5 m
  apart (triangulateRSSIplot.py:64-133).

Geo conversion uses ops.geodesy.meters_to_degrees (111320 m/deg contract).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RssiConfig
from ..ops import cplx, geodesy, pathloss, power as power_ops


class RangingResult(NamedTuple):
    distance_m: jax.Array       # estimated distance; NaN when no signal
    received_db: jax.Array
    mean_amplitude: jax.Array
    onset_index: jax.Array      # -1 when below threshold everywhere


def range_from_iq(iq_normalized: jax.Array, cfg: RssiConfig) -> RangingResult:
    """Distance estimate from one antenna's normalized [-1,1] I/Q capture.

    Mirrors calculate_distance_from_file (triangulateRSSI.py:54-82): first
    amplitude > threshold marks signal turn-on; mean amplitude from there on;
    Prx = 10log10(amp^2); invert the log-distance model.
    """
    amp = jnp.sqrt(cplx.abs2(cplx.asarray(iq_normalized)))
    onset = power_ops.find_first_above(amp, cfg.signal_threshold)
    mean_amp = power_ops.mean_after_onset(amp, onset)
    prx = pathloss.received_power_db(jnp.maximum(mean_amp, 1e-12))
    dist = pathloss.invert_distance_m(prx, cfg.tx_power_dbm,
                                      cfg.path_loss_exponent, cfg.frequency_mhz)
    dist = jnp.where(onset < 0, jnp.nan, dist)
    return RangingResult(dist, prx, mean_amp, onset)


def range_from_file(path: str, cfg: RssiConfig,
                    chunk_samples: int = 1 << 21) -> float:
    """Bounded-memory twin of `range_from_iq` for a capture FILE.

    Streams the normalized amplitude in chunks (host memory = one chunk,
    ~16 MB), finds the turn-on sample and accumulates the post-onset
    mean amplitude in float64 — the calculate_distance_from_file math
    (triangulateRSSI.py:54-82) without loading the capture. Returns the
    distance in meters (NaN when the threshold is never crossed).
    """
    from ..ops import iq as iq_ops

    onset = -1
    amp_sum = 0.0
    amp_cnt = 0
    g0 = 0
    while True:
        x = iq_ops.read_iq_file(path, convention="normalized",
                                count=2 * chunk_samples,
                                offset_bytes=2 * g0)
        if x.size == 0:
            break
        amp = np.abs(x).astype(np.float32)
        if onset < 0:
            above = amp > cfg.signal_threshold
            if above.any():
                i = int(np.argmax(above))
                onset = g0 + i
                amp_sum += float(np.sum(amp[i:], dtype=np.float64))
                amp_cnt += amp.size - i
        else:
            amp_sum += float(np.sum(amp, dtype=np.float64))
            amp_cnt += amp.size
        g0 += x.size
    if onset < 0 or amp_cnt == 0:
        return float("nan")
    mean_amp = max(amp_sum / amp_cnt, 1e-12)
    prx = float(pathloss.received_power_db(jnp.float32(mean_amp)))
    return float(pathloss.invert_distance_m(
        prx, cfg.tx_power_dbm, cfg.path_loss_exponent, cfg.frequency_mhz))


def error_surface(positions: jax.Array, radii: jax.Array,
                  grid_density: int, range_multiplier: float):
    """Sum-abs-error surface over the search grid (triangulateRSSI.py:88-114).

    positions: (n_ant, 2), radii: (n_ant,). Grid spans center +/- 1.5*max_r.
    Returns (err (g, g), grid_x (g,), grid_y (g,)).
    """
    max_r = jnp.max(radii)
    center = jnp.mean(positions, axis=0)
    span = max_r * range_multiplier
    xs = jnp.linspace(center[0] - span, center[0] + span, grid_density)
    ys = jnp.linspace(center[1] - span, center[1] + span, grid_density)
    gx = xs[None, :]                        # row: x varies along axis 1
    gy = ys[:, None]                        # col: y varies along axis 0
    d = jnp.sqrt((gx[..., None] - positions[:, 0]) ** 2
                 + (gy[..., None] - positions[:, 1]) ** 2)   # (g, g, n_ant)
    err = jnp.sum(jnp.abs(d - radii), axis=-1)
    return err, xs, ys


@functools.partial(jax.jit, static_argnames=("grid_density",))
def grid_search(positions: jax.Array, radii: jax.Array,
                grid_density: int = 300,
                range_multiplier: float = 1.5) -> jax.Array:
    """Best (x, y) by minimum total absolute error — perform_grid_search."""
    err, xs, ys = error_surface(positions, radii, grid_density,
                                range_multiplier)
    idx = jnp.argmin(err)
    iy, ix = idx // grid_density, idx % grid_density
    return jnp.stack([xs[ix], ys[iy]])


@functools.partial(jax.jit, static_argnames=("k",))
def _top_k_minima_scan(err: jax.Array, xs: jax.Array, ys: jax.Array,
                       k: int, min_separation_m: float):
    """Greedy k-round suppression, fully on device: each round takes the
    lowest remaining error point and masks everything within
    min_separation of it. Round n therefore yields exactly the n-th pick
    of the reference's sorted-candidate scan (triangulateRSSIplot.py:64-99)
    — the minimum-error point >= min_separation from all earlier picks —
    with no host loop over grid candidates (O(k * grid) vector ops)."""
    g = err.shape[0]
    cx = jnp.tile(xs, g)                        # flat idx = iy * g + ix
    cy = jnp.repeat(ys, g)
    sep2 = jnp.float32(min_separation_m) ** 2

    def round_(flat, _):
        i = jnp.argmin(flat)
        e = flat[i]
        px, py = cx[i], cy[i]
        kill = (cx - px) ** 2 + (cy - py) ** 2 < sep2
        return jnp.where(kill, jnp.inf, flat), (px, py, e)

    _, (px, py, e) = jax.lax.scan(round_, err.reshape(-1).astype(jnp.float32),
                                  None, length=k)
    return jnp.stack([px, py], axis=1), e


def top_k_minima(err: jax.Array, xs: jax.Array, ys: jax.Array,
                 k: int = 8, min_separation_m: float = 5.0):
    """Top-k distinct local minima of the error surface, >= min_separation
    apart (triangulateRSSIplot.py:64-99). Device-side greedy suppression
    (see _top_k_minima_scan); rounds that found no remaining finite point
    (error == inf) are trimmed."""
    picked, errs = _top_k_minima_scan(err, jnp.asarray(xs, jnp.float32),
                                      jnp.asarray(ys, jnp.float32),
                                      k, min_separation_m)
    picked = np.asarray(picked)
    errs = np.asarray(errs)
    n = int(np.sum(np.isfinite(errs)))
    return picked[:n], errs[:n]


def triangulate(file_iqs: Sequence[jax.Array],
                antenna_positions_m: Sequence,
                reference_lat: float = 50.00898,
                reference_lon: float = 19.98287,
                cfg: RssiConfig = RssiConfig()) -> dict:
    """Full localization pipeline; result dict mirrors
    triangulate_jammer_location (triangulateRSSI.py:126-229).

    file_iqs: per-antenna complex captures in the NORMALIZED convention.
    """
    default_pos = [(0.0, 0.0), (0.5, 0.0), (0.0, 0.5)]
    if antenna_positions_m is None:
        antenna_positions_m = default_pos[:len(file_iqs)]

    if len(file_iqs) < 2:
        return {"success": False, "distances": None, "location_meters": None,
                "location_geographic": None,
                "message": "At least 2 antenna captures are required.",
                "num_antennas": len(file_iqs)}

    distances = []
    for x in file_iqs:
        d = float(range_from_iq(x, cfg).distance_m)
        distances.append(None if np.isnan(d) else d)
    return _localize_from_distances(distances, antenna_positions_m,
                                    reference_lat, reference_lon, cfg,
                                    len(file_iqs))


def triangulate_files(paths: Sequence[str],
                      antenna_positions_m: Sequence,
                      reference_lat: float = 50.00898,
                      reference_lon: float = 19.98287,
                      cfg: RssiConfig = RssiConfig()) -> dict:
    """`triangulate` fed by streamed per-file ranging (bounded host
    memory: the whole-capture load of triangulateRSSI.py replaced by
    chunked amplitude accumulation)."""
    default_pos = [(0.0, 0.0), (0.5, 0.0), (0.0, 0.5)]
    if antenna_positions_m is None:
        antenna_positions_m = default_pos[:len(paths)]
    if len(paths) < 2:
        return {"success": False, "distances": None, "location_meters": None,
                "location_geographic": None,
                "message": "At least 2 antenna captures are required.",
                "num_antennas": len(paths)}
    distances = []
    for p in paths:
        d = range_from_file(p, cfg)
        distances.append(None if np.isnan(d) else d)
    return _localize_from_distances(distances, antenna_positions_m,
                                    reference_lat, reference_lon, cfg,
                                    len(paths))


def _localize_from_distances(distances, antenna_positions_m,
                             reference_lat, reference_lon, cfg,
                             n_antennas: int) -> dict:
    valid_pos, valid_r = [], []
    for i, d in enumerate(distances):
        if d is not None and i < len(antenna_positions_m):
            valid_pos.append(antenna_positions_m[i])
            valid_r.append(d)

    if len(valid_r) < 2:
        return {"success": False, "distances": distances,
                "location_meters": None, "location_geographic": None,
                "message": f"Ranging succeeded on only {len(valid_r)} antennas (min 2).",
                "num_antennas": n_antennas}

    best = grid_search(jnp.asarray(valid_pos, jnp.float32),
                       jnp.asarray(valid_r, jnp.float32),
                       grid_density=cfg.grid_density,
                       range_multiplier=cfg.search_range_multiplier)
    bx, by = float(best[0]), float(best[1])
    dlat, dlon = geodesy.meters_to_degrees(bx, by, reference_lat)
    dlat, dlon = float(dlat), float(dlon)
    return {
        "success": True,
        "distances": distances,
        "location_meters": [bx, by],
        "location_geographic": {
            "lat": reference_lat + dlat,
            "lon": reference_lon + dlon,
            "lat_offset_degrees": dlat,
            "lon_offset_degrees": dlon,
            "lat_offset_minutes": dlat * 60,
            "lon_offset_minutes": dlon * 60,
        },
        "message": f"Grid-search localization x={bx:.2f}m, y={by:.2f}m",
        "num_antennas": len(valid_r),
    }
