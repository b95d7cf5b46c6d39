"""PVT: iterative weighted least-squares navigation solution.

Host-side float64 re-design of `blsFilter` + helpers (sdrpvt.c:141-401).
The reference iterates Newton steps with the vendored nml matrix library on
doubles; this solve needs float64 and is tiny (n_sat x 4 normal
equations at a 200 ms cadence), so — per SURVEY.md §7 ("PVT on host or tiny
jitted solve") — it runs on the host, vectorized over satellites. Includes:
- Sagnac (earth-rotation) correction of satellite positions
  (sdrpvt.c:240-245),
- elevation-dependent measurement weighting (sigma^2 = 25 m^2 inflated
  below 30 deg elevation, sdrpvt.c:190-211),
- Goad-Goodman troposphere delay (`tropo`, sdrpvt.c:764-843 — the
  Easy-Suite model with default meteo),
- GDOP from trace((A^T A)^-1) and per-satellite residuals
  (sdrpvt.c:337-350),
- `precheckObs`-style measurement gates (sdrpvt.c:612-762).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ...utils import constants as C


class PvtSolution(NamedTuple):
    pos_ecef: np.ndarray       # (3,)
    clock_bias_m: float        # receiver clock bias [m]
    lat_deg: float
    lon_deg: float
    height_m: float
    gdop: float
    residuals_m: np.ndarray    # (n_sat,) a-posteriori range residuals
    azimuth_deg: np.ndarray    # (n_sat,)
    elevation_deg: np.ndarray  # (n_sat,)
    nsat: int
    valid: bool
    innovations_m: np.ndarray | None = None   # (n_sat,) EKF pre-fit
    vel_ecef: np.ndarray | None = None        # (3,) EKF velocity estimate
    prns: np.ndarray | None = None            # (n_sat,) sat ids per row —
    # set by the caller (which knows the channel list) so telemetry can map
    # residual/az/el/innovation rows back to satellites (the obs_v prn
    # column of sdrsync.c:97-124 that sdrout.c:213-325 reports per sat)


def lla_to_ecef(lat_deg, lon_deg, h_m) -> np.ndarray:
    """Geodetic -> ECEF in float64 (host twin of ops.geodesy.lla_to_ecef,
    which runs float32 on device)."""
    lat = np.deg2rad(np.asarray(lat_deg, np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, np.float64))
    h = np.asarray(h_m, np.float64)
    n = C.WGS84_A / np.sqrt(1.0 - C.WGS84_E_SQ * np.sin(lat) ** 2)
    return np.stack([(n + h) * np.cos(lat) * np.cos(lon),
                     (n + h) * np.cos(lat) * np.sin(lon),
                     (n * (1.0 - C.WGS84_E_SQ) + h) * np.sin(lat)], axis=-1)


def ecef_to_lla(pos: np.ndarray, iterations: int = 10):
    """Iterative geodetic conversion (ecef2lla, sdrpvt.c:416-438)."""
    x, y, z = np.asarray(pos, np.float64)
    lon = np.arctan2(y, x)
    p = np.sqrt(x * x + y * y)
    lat = np.arctan2(z, p * (1.0 - C.WGS84_E_SQ))
    h = 0.0
    for _ in range(iterations):
        n = C.WGS84_A / np.sqrt(1.0 - C.WGS84_E_SQ * np.sin(lat) ** 2)
        h = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1.0 - C.WGS84_E_SQ * n / (n + h)))
    return np.rad2deg(lat), np.rad2deg(lon), h


def topocentric(pos: np.ndarray, d: np.ndarray):
    """ENU components of vectors d as seen from ECEF position pos
    (togeod/topocent, sdrpvt.c:845-967)."""
    lat_deg, lon_deg, _ = ecef_to_lla(pos)
    lat = np.deg2rad(lat_deg)
    lon = np.deg2rad(lon_deg)
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    e = -so * d[..., 0] + co * d[..., 1]
    n = -sl * co * d[..., 0] - sl * so * d[..., 1] + cl * d[..., 2]
    u = cl * co * d[..., 0] + cl * so * d[..., 1] + sl * d[..., 2]
    return e, n, u


def sagnac_rotate(sat_pos: np.ndarray, tau_s: np.ndarray) -> np.ndarray:
    """Rotate satellite ECEF by earth rotation during signal transit
    (sdrpvt.c:240-245): pos' = Rz(omega_e * tau) @ pos."""
    ang = C.OMEGA_E_DOT * np.asarray(tau_s, np.float64)
    ca, sa = np.cos(ang), np.sin(ang)
    x = ca * sat_pos[..., 0] + sa * sat_pos[..., 1]
    y = -sa * sat_pos[..., 0] + ca * sat_pos[..., 1]
    return np.stack([x, y, sat_pos[..., 2]], axis=-1)


def tropo_goad_goodman(sinel, h_m) -> np.ndarray:
    """Goad & Goodman (1974) troposphere delay [m] — the `tropo` model of
    sdrpvt.c:764-843 with its default meteo (p=1013 mbar, T=293 K,
    hum=50 %, reference heights 0). Vectorized over satellites."""
    p, tkel, hum = 1013.0, 293.0, 50.0
    sinel = np.maximum(np.asarray(sinel, np.float64), 0.0)
    hsta = np.asarray(h_m, np.float64) * 1e-3          # km
    a_e = 6378.137
    b0 = 7.839257e-5
    tlapse = -6.5
    atkel = 7.5 * (tkel - 273.15) / (237.3 + tkel - 273.15)
    e0 = 0.0611 * hum * 10.0 ** atkel
    tksea = tkel
    em = -978.77 / (2.8704e6 * tlapse * 1.0e-5)
    e0sea = e0                                          # ref heights all 0
    psea = p

    def component(ref_scale, htop):
        ref = ref_scale * ((htop - hsta) / htop) ** 4
        rtop = (a_e + htop) ** 2 - (a_e + hsta) ** 2 * (1.0 - sinel ** 2)
        rtop = np.sqrt(np.maximum(rtop, 0.0)) - (a_e + hsta) * sinel
        a = -sinel / (htop - hsta)
        b = -b0 * (1.0 - sinel ** 2) / (2.0 * (htop - hsta))
        rn = np.stack([rtop ** (i + 2) for i in range(8)], axis=-1)
        alpha = np.stack(np.broadcast_arrays(
            2.0 * a,
            2.0 * a ** 2 + 4.0 * b / 3.0,
            a * (a ** 2 + 3.0 * b),
            a ** 4 / 5.0 + 2.4 * a ** 2 * b + 1.2 * b ** 2,
            2.0 * a * b * (a ** 2 + 3.0 * b) / 3.0,
            b ** 2 * (6.0 * a ** 2 + 4.0 * b) / 7.0,
            np.where(b * b > 1e-35, a * b ** 3 / 2.0, 0.0),
            np.where(b * b > 1e-35, b ** 4 / 9.0, 0.0)), axis=-1)
        dr = rtop + np.sum(alpha * rn, axis=-1)
        return dr * ref * 1000.0

    refsea_d = 77.624e-6 / tksea
    htop_d = 1.1385e-5 / refsea_d
    dry = component(refsea_d * psea, htop_d)
    refsea_w = (371900.0e-6 / tksea - 12.92e-6) / tksea
    htop_w = 1.1385e-5 * (1255.0 / tksea + 0.05) / refsea_w
    wet = component(refsea_w * e0sea, htop_w)
    del em
    return dry + wet


def elevation_weights(el_deg: np.ndarray) -> np.ndarray:
    """Weights = 1/sigma^2 with sigma^2 = 25 m^2, inflated below 30 deg
    elevation by 1/sin^2(el) (sdrpvt.c:190-211)."""
    el = np.asarray(el_deg, np.float64)
    sin_el = np.sin(np.deg2rad(np.maximum(el, 5.0)))
    var = np.where(el < 30.0, 25.0 / (sin_el * sin_el), 25.0)
    return 1.0 / var


def solve_wls(sat_pos, pseudoranges, sat_clk_s, mask=None, x0=None,
              iterations: int = 10, use_tropo: bool = True) -> PvtSolution:
    """Iterative WLS position fix (blsFilter, sdrpvt.c:141-401).

    Args:
      sat_pos: (n, 3) satellite ECEF at transmit time [m].
      pseudoranges: (n,) measured pseudoranges [m].
      sat_clk_s: (n,) satellite clock corrections [s] (added back as c*clk,
        per pvtProcessor sdrpvt.c:95-109).
      mask: (n,) bool — which measurements participate (default all).
      x0: optional (4,) initial [x, y, z, clock_bias_m].
    """
    sat_pos = np.asarray(sat_pos, np.float64)
    n = sat_pos.shape[0]
    mask = np.ones(n, bool) if mask is None else np.asarray(mask, bool)
    m = mask.astype(np.float64)
    pr = (np.asarray(pseudoranges, np.float64)
          + C.SPEED_OF_LIGHT * np.asarray(sat_clk_s, np.float64))
    st = np.zeros(4) if x0 is None else np.asarray(x0, np.float64).copy()

    el = np.zeros(n)
    trop = np.zeros(n)
    for it in range(iterations):
        pos, bias = st[:3], st[3]
        rho0 = np.linalg.norm(sat_pos - pos, axis=-1)
        tau = (rho0 + bias) / C.SPEED_OF_LIGHT
        sp = sagnac_rotate(sat_pos, tau)
        d = sp - pos
        rho = np.linalg.norm(d, axis=-1)
        u = d / rho[:, None]
        if it >= 2:
            _, _, hgt = ecef_to_lla(pos)
            e_, n_, up = topocentric(pos, d)
            el = np.rad2deg(np.arctan2(up, np.hypot(e_, n_)))
            trop = (tropo_goad_goodman(np.sin(np.deg2rad(el)), hgt)
                    if use_tropo else np.zeros(n))
            w = m * elevation_weights(el)
        else:
            w = m
        res = pr - rho - bias - trop
        a = np.concatenate([-u, np.ones((n, 1))], axis=-1)
        aw = a * w[:, None]
        ata = aw.T @ a + 1e-9 * np.eye(4)
        delta = np.linalg.solve(ata, aw.T @ res)
        st = st + delta
        if np.linalg.norm(delta) < 1e-4:
            break

    pos, bias = st[:3], st[3]
    rho0 = np.linalg.norm(sat_pos - pos, axis=-1)
    tau = (rho0 + bias) / C.SPEED_OF_LIGHT
    sp = sagnac_rotate(sat_pos, tau)
    d = sp - pos
    rho = np.linalg.norm(d, axis=-1)
    u = d / rho[:, None]
    lat, lon, hgt = ecef_to_lla(pos)
    e_, n_, up = topocentric(pos, d)
    az = np.rad2deg(np.arctan2(e_, n_)) % 360.0
    el = np.rad2deg(np.arctan2(up, np.hypot(e_, n_)))
    trop = (tropo_goad_goodman(np.sin(np.deg2rad(el)), hgt)
            if use_tropo else np.zeros(n))
    residuals = (pr - rho - bias - trop) * m

    a = np.concatenate([-u, np.ones((n, 1))], axis=-1) * m[:, None]
    try:
        q = np.linalg.inv(a.T @ a)
        gdop = float(np.sqrt(np.trace(q)))
    except np.linalg.LinAlgError:
        gdop = float("inf")
    nsat = int(mask.sum())
    valid = bool(nsat >= 4 and np.all(np.isfinite(st)) and gdop < 100.0)
    return PvtSolution(pos_ecef=pos, clock_bias_m=float(bias),
                       lat_deg=float(lat), lon_deg=float(lon),
                       height_m=float(hgt), gdop=gdop,
                       residuals_m=residuals, azimuth_deg=az,
                       elevation_deg=el, nsat=nsat, valid=valid)


def precheck_mask(snr_dbhz, week, tow_s, pr_m, eph_complete, el_deg=None,
                  snr_min: float = 19.0, week_min: int = 2360,
                  el_min_deg: float = 15.0,
                  pr_max_ms: float = 92.0) -> np.ndarray:
    """Measurement quality gates of precheckObs (sdrpvt.c:612-762):
    SNR >= 19 dB-Hz, valid week/ToW, pseudorange inside (0, 92 ms * c),
    complete ephemeris; the elevation gate applies only once an elevation
    estimate exists."""
    pr_hi = pr_max_ms * 1e-3 * C.SPEED_OF_LIGHT
    ok = ((np.asarray(snr_dbhz, np.float64) >= snr_min)
          & (np.asarray(week) >= week_min)
          & (np.asarray(tow_s, np.float64) >= 1.0)
          & (np.asarray(pr_m, np.float64) > 0.0)
          & (np.asarray(pr_m, np.float64) < pr_hi)
          & np.asarray(eph_complete, bool))
    if el_deg is not None:
        el = np.asarray(el_deg, np.float64)
        ok = ok & np.where(np.isfinite(el), el >= el_min_deg, True)
    return ok


class PvtEkf:
    """8-state pseudorange EKF: position, velocity, clock bias, drift.

    The reference RESERVES an EKF (the `FILTER|` telemetry field, the
    `ekfFilterOn` flag sdrinit.c:117, and an `sdrekf_t` that carries only
    measurement variances, sdr.h:381-384) but its branch is empty
    (sdrpvt.c:85-88 falls through to blsFilter). This implements the
    missing filter: constant-velocity + 2-state clock dynamics, the same
    measurement model as solve_wls (Sagnac + Hopfield-style tropo +
    elevation-dependent variances, sdrpvt.c:141-330), per-satellite
    pre-fit innovations (the `innovation` telemetry column sdrout.c
    always reported as 0), and coasting through short outages.
    """

    NSTATE = 8                 # [x y z vx vy vz b bdot], meters / m/s

    def __init__(self, accel_psd: float = 1.0, clk_bias_psd: float = 4.0,
                 clk_drift_psd: float = 0.5, use_tropo: bool = True,
                 innovation_gate_m: float = 200.0,
                 max_coast_s: float = 5.0):
        self.accel_psd = accel_psd
        self.clk_bias_psd = clk_bias_psd
        self.clk_drift_psd = clk_drift_psd
        self.use_tropo = use_tropo
        self.innovation_gate_m = innovation_gate_m
        self.max_coast_s = max_coast_s
        self.x: np.ndarray | None = None
        self.P: np.ndarray | None = None
        self.coast_s = 0.0

    @property
    def initialized(self) -> bool:
        return self.x is not None

    def initialize(self, sol: PvtSolution) -> None:
        """Seed from a WLS fix (position + clock; zero velocity/drift)."""
        self.x = np.concatenate([sol.pos_ecef, np.zeros(3),
                                 [sol.clock_bias_m, 0.0]])
        self.P = np.diag([100.0 ** 2] * 3 + [10.0 ** 2] * 3
                         + [1000.0 ** 2, 100.0 ** 2]).astype(np.float64)
        self.coast_s = 0.0

    def _predict(self, dt: float) -> None:
        F = np.eye(self.NSTATE)
        for i in range(3):
            F[i, 3 + i] = dt
        F[6, 7] = dt
        q2 = self.accel_psd ** 2
        Qpv = np.array([[dt ** 3 / 3.0, dt ** 2 / 2.0],
                        [dt ** 2 / 2.0, dt]])
        Q = np.zeros((self.NSTATE, self.NSTATE))
        for i in range(3):
            Q[np.ix_([i, 3 + i], [i, 3 + i])] += q2 * Qpv
        Qc = np.array([[dt ** 3 / 3.0, dt ** 2 / 2.0],
                       [dt ** 2 / 2.0, dt]]) * self.clk_drift_psd ** 2
        Qc[0, 0] += self.clk_bias_psd ** 2 * dt
        Q[np.ix_([6, 7], [6, 7])] += Qc
        self.x = F @ self.x
        self.P = F @ self.P @ F.T + Q

    def step(self, sat_pos, pseudoranges, sat_clk_s, mask=None,
             dt_s: float = 0.2) -> PvtSolution:
        """Predict + measurement update; coasts (predict-only, valid while
        coast time < max_coast_s) when fewer than 4 gated measurements
        survive — the availability the reference's snapshot WLS lacks."""
        assert self.initialized, "call initialize() with a WLS fix first"
        sat_pos = np.asarray(sat_pos, np.float64)
        n = sat_pos.shape[0]
        mask = np.ones(n, bool) if mask is None else np.asarray(mask, bool)
        pr = (np.asarray(pseudoranges, np.float64)
              + C.SPEED_OF_LIGHT * np.asarray(sat_clk_s, np.float64))
        self._predict(dt_s)

        pos, bias = self.x[:3], self.x[6]
        rho0 = np.linalg.norm(sat_pos - pos, axis=-1)
        tau = (rho0 + bias) / C.SPEED_OF_LIGHT
        sp = sagnac_rotate(sat_pos, tau)
        d = sp - pos
        rho = np.linalg.norm(d, axis=-1)
        u = d / rho[:, None]
        lat, lon, hgt = ecef_to_lla(pos)
        e_, n_, up = topocentric(pos, d)
        az = np.rad2deg(np.arctan2(e_, n_)) % 360.0
        el = np.rad2deg(np.arctan2(up, np.hypot(e_, n_)))
        trop = (tropo_goad_goodman(np.sin(np.deg2rad(el)), hgt)
                if self.use_tropo else np.zeros(n))
        innov = pr - (rho + bias + trop)
        use = mask & (np.abs(innov) < self.innovation_gate_m)

        nsat = int(use.sum())
        gdop = float("inf")
        if nsat >= 4:
            H = np.zeros((nsat, self.NSTATE))
            H[:, :3] = -u[use]
            H[:, 6] = 1.0
            Rv = np.diag(1.0 / elevation_weights(el[use]))
            S = H @ self.P @ H.T + Rv
            K = self.P @ H.T @ np.linalg.inv(S)
            self.x = self.x + K @ innov[use]
            ikh = np.eye(self.NSTATE) - K @ H
            self.P = ikh @ self.P @ ikh.T + K @ Rv @ K.T   # Joseph form
            self.coast_s = 0.0
            try:
                q = np.linalg.inv(H[:, [0, 1, 2, 6]].T @ H[:, [0, 1, 2, 6]])
                gdop = float(np.sqrt(np.trace(q)))
            except np.linalg.LinAlgError:
                pass
        else:
            self.coast_s += dt_s

        pos, bias = self.x[:3], self.x[6]
        lat, lon, hgt = ecef_to_lla(pos)
        d2 = sagnac_rotate(sat_pos, tau) - pos
        rho2 = np.linalg.norm(d2, axis=-1)
        residuals = (pr - rho2 - bias - trop) * use
        valid = bool(np.all(np.isfinite(self.x))
                     and (nsat >= 4 or self.coast_s <= self.max_coast_s))
        return PvtSolution(
            pos_ecef=pos.copy(), clock_bias_m=float(bias),
            lat_deg=float(lat), lon_deg=float(lon), height_m=float(hgt),
            gdop=gdop, residuals_m=residuals, azimuth_deg=az,
            elevation_deg=el, nsat=nsat, valid=valid,
            innovations_m=innov * mask, vel_ecef=self.x[3:6].copy())
