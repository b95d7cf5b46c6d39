"""Geodetic conversions and topocentric geometry.

Array equivalents of `sdrpvt.c:416-438` (ecef2lla iterative),
`sdrpvt.c:845-967` (togeod/topocent az/el), `add_jammer_and_mix.py:14-24`
(lla2ecef), `triangulateRSSI.py:42-52` (small-offset meters<->degrees) and the
haversine distance used by the accuracy harness (`helpers/analyze_position.py`).

All functions are jnp, jit/vmap-friendly, float64-free (float32 is plenty for
the <1 m localization target at these scales; PVT runs float64 on host via
numpy where precision matters — see models/receiver/pvt.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils import constants as C


def lla_to_ecef(lat_deg, lon_deg, alt_m):
    """WGS-84 geodetic -> ECEF (add_jammer_and_mix.py:14-24)."""
    lat = jnp.radians(lat_deg)
    lon = jnp.radians(lon_deg)
    sl = jnp.sin(lat)
    n = C.WGS84_A / jnp.sqrt(1.0 - C.WGS84_E_SQ * sl * sl)
    x = (n + alt_m) * jnp.cos(lat) * jnp.cos(lon)
    y = (n + alt_m) * jnp.cos(lat) * jnp.sin(lon)
    z = (n * (1.0 - C.WGS84_E_SQ) + alt_m) * sl
    return x, y, z


def ecef_to_lla(x, y, z, iterations: int = 10):
    """ECEF -> WGS-84 geodetic by fixed-point iteration.

    Same scheme as the reference's ecef2lla (sdrpvt.c:416-438) but with a
    fixed iteration count (static under jit) instead of a while-convergence
    loop; 10 iterations converge well below 1 cm.
    Returns (lat_deg, lon_deg, height_m).
    """
    lon = jnp.arctan2(y, x)
    p = jnp.sqrt(x * x + y * y)
    e2 = C.WGS84_E_SQ
    phi = jnp.arctan2(z, p * (1.0 - e2))
    h = jnp.zeros_like(p)

    def body(_, carry):
        phi, h = carry
        sp = jnp.sin(phi)
        n = C.WGS84_A / jnp.sqrt(1.0 - e2 * sp * sp)
        h = p / jnp.cos(phi) - n
        phi = jnp.arctan2(z, p * (1.0 - e2 * (n / (n + h))))
        return phi, h

    phi, h = jax.lax.fori_loop(0, iterations, body, (phi, h))
    return jnp.degrees(phi), jnp.degrees(lon), h


def enu_basis(lat_deg, lon_deg):
    """Rows: east, north, up unit vectors at the given geodetic location."""
    lat = jnp.radians(lat_deg)
    lon = jnp.radians(lon_deg)
    sl, cl = jnp.sin(lat), jnp.cos(lat)
    so, co = jnp.sin(lon), jnp.cos(lon)
    e = jnp.stack([-so, co, jnp.zeros_like(so)], axis=-1)
    n = jnp.stack([-sl * co, -sl * so, cl], axis=-1)
    u = jnp.stack([cl * co, cl * so, sl], axis=-1)
    return e, n, u


def topocentric(obs_ecef, dx_ecef):
    """Azimuth/elevation/distance of dx (ECEF delta) seen from obs_ecef.

    The topocent math of sdrpvt.c:845-967: convert the line-of-sight vector
    into the local ENU frame at the observer and read off az/el.
    Returns (az_deg in [0,360), el_deg, dist_m).
    """
    lat, lon, _ = ecef_to_lla(obs_ecef[..., 0], obs_ecef[..., 1], obs_ecef[..., 2])
    e, n, u = enu_basis(lat, lon)
    de = jnp.sum(dx_ecef * e, axis=-1)
    dn = jnp.sum(dx_ecef * n, axis=-1)
    du = jnp.sum(dx_ecef * u, axis=-1)
    dist = jnp.sqrt(de * de + dn * dn + du * du)
    horiz = jnp.sqrt(de * de + dn * dn)
    az = jnp.degrees(jnp.arctan2(de, dn)) % 360.0
    el = jnp.degrees(jnp.arctan2(du, jnp.maximum(horiz, 1e-12)))
    return az, el, dist


def meters_to_degrees(dx_east_m, dy_north_m, reference_lat_deg):
    """Small-offset meters -> (dlat_deg, dlon_deg) (triangulateRSSI.py:42-52)."""
    dlat = dy_north_m / C.METERS_PER_DEGREE_LAT
    mlon = C.METERS_PER_DEGREE_LON * jnp.cos(jnp.radians(reference_lat_deg))
    dlon = dx_east_m / mlon
    return dlat, dlon


def degrees_to_meters(dlat_deg, dlon_deg, reference_lat_deg):
    """Inverse of meters_to_degrees."""
    dy = dlat_deg * C.METERS_PER_DEGREE_LAT
    dx = dlon_deg * C.METERS_PER_DEGREE_LON * jnp.cos(jnp.radians(reference_lat_deg))
    return dx, dy


def haversine_m(lat1_deg, lon1_deg, lat2_deg, lon2_deg):
    """Great-circle distance in meters (helpers/analyze_position.py oracle)."""
    r = 6_371_000.0
    p1, p2 = jnp.radians(lat1_deg), jnp.radians(lat2_deg)
    dp = p2 - p1
    dl = jnp.radians(lon2_deg - lon1_deg)
    a = jnp.sin(dp / 2) ** 2 + jnp.cos(p1) * jnp.cos(p2) * jnp.sin(dl / 2) ** 2
    return 2 * r * jnp.arcsin(jnp.sqrt(a))
