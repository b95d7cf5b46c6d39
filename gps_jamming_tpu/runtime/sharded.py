"""Sharded product analysis: `detect --devices N` over a device mesh.

Promotes the `parallel.fusion` library (psum Welch fusion, all-gather
power profiles, sharded PCF acquisition, all-pairs TDOA xcorr — the
multi-chip design SURVEY §2.3 assigns to the framework) into a
CLI-reachable product path over a real multi-antenna capture set. The
same collectives the driver's `dryrun_multichip` proves at toy shapes run
here over actual files, and every output is numerically identical to the
single-device kernels on the same bytes (asserted in
tests/test_sharded_detect.py).

Mesh layout: ('antenna', 'time') with the antenna axis sized to the
number of capture files (the reference's 1-3 RTL-SDR receivers,
ui_mainwindow.py:633-651) and the time axis soaking up the remaining
devices — each antenna's stream is split into time shards whose PSD /
power / CAF partials are fused with psum/all_gather, replacing
the reference's per-receiver HTTP fan-in (sdrout.c:10-57).
"""
from __future__ import annotations

import numpy as np

import jax

from ..config import DEFAULT_CONFIG, FrameworkConfig
from ..models import detector
from ..ops import cplx
from ..parallel import fusion
from ..parallel import mesh as mesh_lib

SLICE_LEN = 4096                   # TDOA xcorr slice per antenna


def _load_planar(path: str, n: int) -> cplx.CArray:
    """uint8 interleaved file -> centered planar float32 (host).

    Delegates the centering contract to ops.iq.read_iq_file so the
    -127.5 convention lives in exactly one place."""
    from ..ops import iq as iq_ops
    x = iq_ops.read_iq_file(path, convention="centered", count=2 * n)
    return cplx.CArray(np.ascontiguousarray(x.real.astype(np.float32)),
                       np.ascontiguousarray(x.imag.astype(np.float32)))


def analyze_capture_sharded(paths, n_devices: int | None = None,
                            cfg: FrameworkConfig = DEFAULT_CONFIG,
                            system: str = "gps",
                            sample_rate: float | None = None,
                            max_seconds: float | None = None,
                            acq_periods_per_shard: int = 8,
                            devices=None) -> dict:
    """Analyze 1-3 antenna captures on an ('antenna', 'time') mesh.

    Returns a JSON-able dict: fused + per-antenna PSD stats, per-antenna
    F1 power ranges and events (the worker.py:198-275 pre-scan as a
    sharded computation), PCF acquisition peaks from the capture head,
    and all-pairs TDOA cross-correlation lags at the first detected
    onset. Equality with the single-device path is part of the contract
    (the fusion kernels are exact, not approximate — test-asserted).
    """
    import os

    if sample_rate is not None:
        fs = float(sample_rate)
    elif system == "glonass":
        from ..config import FrontendConfig, GnssSystem
        fs = FrontendConfig.for_system(GnssSystem.GLONASS).sample_rate_hz
    else:
        fs = cfg.frontend.sample_rate_hz

    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n_ant = len(paths)
    n_time = max(len(devs) // n_ant, 1)
    mesh = mesh_lib.make_mesh(n_ant, n_time, devices=devs[:n_ant * n_time])

    n = min(os.path.getsize(p) // 2 for p in paths)
    if max_seconds is not None:
        n = min(n, int(max_seconds * fs))
    chunk = cfg.detector.power_chunk_samples
    L = (n // (n_time * chunk)) * chunk    # whole chunks per time shard
    if L == 0:
        raise ValueError(f"capture too short for a {n_time}-way time "
                         f"split of {chunk}-sample chunks")
    caps = [_load_planar(p, L * n_time) for p in paths]
    blocks = cplx.CArray(
        np.stack([c.re[:L * n_time].reshape(n_time, L) for c in caps]),
        np.stack([c.im[:L * n_time].reshape(n_time, L) for c in caps]))

    # --- sharded PSD + F1 power profiles (psum + all_gather) -------------
    psd_fused, psd_ant, pm = fusion.sharded_psd_and_power(
        blocks, mesh, fs, cfg.detector, cfg.spectral)
    pm = np.asarray(pm)
    per_antenna = []
    for i, p in enumerate(paths):
        pmap = pm[i]
        import jax.numpy as jnp
        from ..ops import power as power_ops
        base = power_ops.power_baseline(jnp.asarray(pmap),
                                        cfg.detector.baseline_percentile)
        thr = power_ops.power_threshold_linear(
            base, cfg.detector.power_rise_db)
        prof = detector.PowerProfile(jnp.asarray(pmap), base, thr,
                                     jnp.asarray(pmap) > np.asarray(thr))
        ranges = detector.power_profile_ranges(prof, cfg.detector)
        per_antenna.append({
            "file": p,
            "power_ranges_bytes": ranges,
            "baseline": float(np.asarray(base)),
            "threshold": float(np.asarray(thr)),
        })

    # --- sharded PCF acquisition on the capture head ---------------------
    acq = None
    if system == "gps":
        from ..models.receiver import acquisition as acq_mod
        from ..ops import caf as caf_ops
        n_code = int(round(fs * 1e-3))
        per_shard = acq_periods_per_shard * n_code
        if L >= per_shard:
            replica = acq_mod.gps_replica_table_host(fs, n_code)
            acq_blocks = cplx.apply(
                lambda a: a[:, :, :per_shard], blocks)
            gb = max(acq_periods_per_shard // 2, 1)
            surf = fusion.sharded_caf_acquire(
                acq_blocks, mesh, replica, None, fs, method="pcf",
                group_blocks=gb)
            surf = np.asarray(surf)            # (n_ant, n_prn, nf, n_code)
            dopp = caf_ops.pcf_doppler_hz(fs, n_code, 7000.0)
            acq = []
            for i in range(n_ant):
                flat = surf[i].reshape(surf.shape[1], -1)
                peak = flat.max(axis=-1)
                order = np.argsort(-peak)[:4]
                acq.append([
                    {"prn": int(pr) + 1,
                     "peak": float(peak[pr]),
                     "doppler_hz": float(
                         dopp[flat[pr].argmax() // surf.shape[-1]])}
                    for pr in order])

    # --- sharded all-pairs TDOA xcorr at the first onset -----------------
    tdoa = None
    if n_ant >= 2:
        ranges0 = per_antenna[0]["power_ranges_bytes"]
        start = ranges0[0][0] // 2 if ranges0 else 0
        start = min(start, L * n_time - SLICE_LEN)
        flat = cplx.CArray(blocks.re.reshape(n_ant, -1),
                           blocks.im.reshape(n_ant, -1))
        sl = cplx.apply(lambda a: a[:, start:start + SLICE_LEN], flat)
        xc = np.asarray(fusion.sharded_pair_xcorr(sl, mesh))
        import itertools
        pairs = list(itertools.combinations(range(n_ant), 2))
        nfft = xc.shape[-1]
        lags = []
        for k, (i, j) in enumerate(pairs):
            lag = int(xc[k].argmax())
            if lag > nfft // 2:
                lag -= nfft
            lags.append({"pair": [i, j], "lag_samples": lag,
                         "lag_s": lag / fs})
        tdoa = lags

    psd_fused = np.asarray(psd_fused)
    freqs = np.fft.fftfreq(psd_fused.size, 1.0 / fs)
    return {
        "mesh": {"antenna": n_ant, "time": n_time,
                 "devices": n_ant * n_time},
        "psd_fused_peak_db": float(10.0 * np.log10(psd_fused.max())),
        "psd_fused_peak_freq_hz": float(freqs[int(psd_fused.argmax())]),
        "per_antenna": per_antenna,
        "acquisition": acq,
        "tdoa_pairs": tdoa,
    }
