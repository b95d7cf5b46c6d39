"""Benchmark harness: flagship single-chip throughput + weak scaling.

The BASELINE.md performance envelope is "I/Q Msamples/s/chip at 1 chip,
1 host, and N>=2 hosts with >=80% weak-scaling efficiency". This module
provides both measurements as a library + the CLI `benchmark` verb:

- `single_chip()` runs the fused detection+acquisition chain (bench.py's
  flagship step) on the current backend with host-fetch-synchronized slope
  timing.
- `weak_scaling(device_counts)` measures the sharded multi-antenna
  PSD/power step (parallel.fusion: ppermute halo exchange + psum antenna
  fusion + all_gather) at a FIXED per-device workload over growing meshes.
  Each mesh size runs in a subprocess because the device count must be
  fixed before the JAX backend initializes
  (`--xla_force_host_platform_device_count` for the virtual CPU mesh; on a
  multi-GPU host, pass platform='gpu' to use the local cards).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

_PER_DEVICE_SAMPLES = 1 << 19          # weak-scaling workload per device
_BLOCK = 1 << 14


def _slope_time(fn, *args, n_lo=2, n_hi=12, reps=3) -> float:
    """Sustained seconds/step via fetch-synchronized two-point timing."""
    import jax

    def fetch(out):
        return jax.tree_util.tree_map(np.asarray, out)

    fetch(fn(*args))
    def timed(n):
        out = None
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn(*args)
        fetch(out)
        return time.perf_counter() - t0

    lo = [timed(n_lo) for _ in range(reps)]
    hi = [timed(n_hi) for _ in range(reps)]
    return max((float(np.median(hi)) - float(np.median(lo)))
               / (n_hi - n_lo), 1e-9)


def single_chip() -> dict:
    """Flagship detection+acquisition chain throughput on this backend."""
    import bench as _bench_mod  # repo-root bench.py when run from checkout
    jfn, raw, n_block = _bench_mod._build_chain()
    msps = _bench_mod._time_chain(jfn, raw, n_block)
    import jax
    return {"metric": "iq_detect_acquire_throughput",
            "backend": jax.default_backend(),
            "msamples_per_s_per_chip": round(msps, 2)}


def _bench_capture(system: str, seconds: float, seed: int = 5):
    """Geometry-true simulated capture at the constellation's native rate
    (host-side, excluded from timing): GPS 2.048 MS/s (sdrinit.c:11-13),
    GLONASS 10 MS/s (sdrinit.c:6-9), Galileo E1B BOC at 4.096 MS/s
    (>= 2 samples per half-chip; the reference's 2.048 MS/s undersamples
    BOC(1,1) — this framework's receiver needs the honest rate).

    Returns (complex64 samples, sample rate, per-satellite truths,
    receiver ECEF position)."""
    from ..models.receiver import lnav
    from ..models.receiver import pvt as pvt_mod
    from ..sim import constellation

    rx_lla = (50.06, 19.94, 219.0)
    toe = 345600.0

    def kepler_shell(n, sqrt_a, week, incl):
        return [lnav.Ephemeris(
            prn=k + 1, week=week, toc=toe, af0=0.0, af1=0.0, af2=0.0,
            tgd=0.0, iodc=100 + k, ura=1, health=0, iode=100 + k, toe=toe,
            sqrt_a=sqrt_a, e=0.005, m0=2.0 * np.pi * k / n,
            delta_n=4e-9, omega0=2.0 * np.pi * (k % 6) / 6.0,
            omega_dot=-8.0e-9, omega=0.25 * k, i0=incl, idot=-3e-10,
            cuc=0.0, cus=0.0, crc=0.0, crs=0.0, cic=0.0, cis=0.0,
            have_subframes=(1, 2, 3)) for k in range(n)]

    if system == "gps":
        fs = 2.048e6
        n = int(seconds * fs)
        sig, truths, rx_ecef = constellation.simulate_constellation(
            kepler_shell(24, np.sqrt(26_560_000.0), 2400, 0.958),
            rx_lla, toe - 1.3, n, fs, noise_std=0.35, seed=seed)
        return sig.astype(np.complex64), fs, truths, rx_ecef
    if system == "galileo":
        fs = 4.096e6
        n = int(seconds * fs)
        sig, truths, rx_ecef = constellation.simulate_galileo_constellation(
            kepler_shell(24, np.sqrt(29_600_000.0), 1340, 0.975),
            rx_lla, toe + 30.0, n, fs, noise_std=0.35, seed=seed)
        return sig.astype(np.complex64), fs, truths, rx_ecef
    if system == "glonass":
        from ..models.receiver import glonass as glo
        fs = 10.0e6
        n = int(seconds * fs)
        rx = pvt_mod.lla_to_ecef(*rx_lla)
        lat, lon = np.deg2rad(rx_lla[0]), np.deg2rad(rx_lla[1])
        e_hat = np.array([-np.sin(lon), np.cos(lon), 0.0])
        n_hat = np.array([-np.sin(lat) * np.cos(lon),
                          -np.sin(lat) * np.sin(lon), np.cos(lat)])
        u_hat = np.array([np.cos(lat) * np.cos(lon),
                          np.cos(lat) * np.sin(lon), np.sin(lat)])
        r_orb = 25_508_000.0
        sats = []
        for i, (az_d, el_d) in enumerate(
                [(0.0, 65.0), (85.0, 40.0), (170.0, 55.0),
                 (255.0, 35.0), (320.0, 70.0)]):
            az, el = np.deg2rad(az_d), np.deg2rad(el_d)
            ray = (np.sin(az) * np.cos(el) * e_hat
                   + np.cos(az) * np.cos(el) * n_hat
                   + np.sin(el) * u_hat)
            b = 2.0 * rx.dot(ray)
            c0 = rx.dot(rx) - r_orb ** 2
            d = (-b + np.sqrt(b * b - 4 * c0)) / 2.0
            pos = rx + d * ray
            v_circ = np.sqrt(3.986e14 / r_orb)
            t1 = np.cross(pos, [0.0, 0.0, 1.0])
            t1 /= np.linalg.norm(t1)
            t2 = np.cross(pos / np.linalg.norm(pos), t1)
            vel = v_circ * (np.cos(0.7 * i) * t1 + np.sin(0.7 * i) * t2)
            sats.append(glo.GloEphemeris(
                freq_ch=i - 2, tb_s=27000.0, tk_s=0.0, pos_m=tuple(pos),
                vel_mps=tuple(vel), acc_mps2=(0.0, 0.0, 0.0),
                tau_s=(i - 2) * 4e-6, gamma=0.0))
        sig, truths, rx_ecef = constellation.simulate_glonass_constellation(
            sats, rx_lla, 27030.0, n, fs, noise_std=0.35, seed=seed)
        return sig.astype(np.complex64), fs, truths, rx_ecef
    raise ValueError(f"unknown system {system!r}")


def receiver_chain(system: str = "gps", seconds: float = 6.0,
                   segment_s: float = 2.0, wire_bits: int | str = "auto",
                   n_slots: int | None = None) -> dict:
    """Receiver-chain throughput for one constellation (VERDICT r3 item 3).

    Runs the PRODUCT receiver — the self-healing StreamingReceiver
    (per-segment batched acquisition + fixed-rate tracking scans + host
    decode + PVT, the sdrtrk.c:3-41 hot loop + sdrmain.c real-time
    posture) — end-to-end on a geometry-true simulated capture at the
    constellation's native rate, and reports:
      - e2e wall-clock Msamples/s + realtime multiple (everything:
        device scans, per-segment acquisition, host decode, PVT);
      - the device tracking-scan cost alone via slope timing (the honest
        per-kernel number; host work overlaps it in steady state).
    """
    import tempfile

    import jax

    from ..ops import cplx, iq as iq_ops
    from . import rx_stream

    sig, fs, _, _ = _bench_capture(system, seconds)
    n = sig.shape[-1]
    rx = rx_stream.StreamingReceiver(fs, system=system,
                                     segment_s=segment_s,
                                     n_slots=n_slots)
    xp = cplx.from_complex(sig)

    # the PRODUCT path: uint8 capture on disk -> process_file (int8
    # segment windows uploaded + converted on device, bounded HBM)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/bench_{system}.bin"
        iq_ops.write_iq_file(path, (sig * 12.0).astype(np.complex64))
        t0 = time.perf_counter()
        rx.process_file(path, convention="centered",
                        wire_bits=wire_bits)           # warm-up: compiles
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = rx.process_file(path, convention="centered",
                              wire_bits=wire_bits)
        wall = time.perf_counter() - t0

    # device tracking-scan slope time (one segment, all slots)
    import jax.numpy as jnp

    from ..models.receiver import tracking
    st = tracking.init_state(
        rx.n_slots, np.zeros(rx.n_slots, np.float32),
        np.zeros(rx.n_slots, np.float32), fs,
        code_len=rx.su["code_len"], chip_rate=rx.su["chip_rate"])
    tab = np.zeros((rx.n_slots, rx.su["code_len"]), np.float32)
    carr = np.full(rx.n_slots, 1575.42e6, np.float32)
    offhz = np.zeros(rx.n_slots, np.float32)
    W = rx.segment_window_samples()
    xw = cplx.apply(lambda a: jax.lax.dynamic_slice(a, (0,), (W,)), xp)
    offs_ages = jnp.zeros((2, rx.n_slots), jnp.int32)
    args = (st, xw, offs_ages, jnp.asarray(tab),
            jnp.asarray(carr), jnp.asarray(offhz))
    dt_scan = _slope_time(rx._jit_run, *args, n_lo=2, n_hi=8)
    seg_samples = rx.seg_epochs * rx.n_epoch

    # whole segments only: the realtime multiple must count the samples
    # the receiver actually processed, not the file tail it skipped
    n_used = ((n - rx.su["n_code"]) // seg_samples) * seg_samples
    return {
        "system": system, "sample_rate_hz": fs,
        "capture_s": round(n / fs, 2),
        "processed_s": round(n_used / fs, 2),
        "n_slots": rx.n_slots,
        # resolved width (an "auto" request records what it picked)
        "wire_bits": {"i8": 8, "i4": 4, "i2": 2,
                      "i1": 1}[rx._ingest_conv[0]],
        "e2e_wall_s": round(wall, 3),
        "e2e_msamples_per_s": round(n_used / wall / 1e6, 2),
        "e2e_realtime_x": round(n_used / fs / wall, 2),
        "track_scan_s_per_segment": round(dt_scan, 5),
        "track_msamples_per_s": round(seg_samples / dt_scan / 1e6, 2),
        "track_realtime_x": round(seg_samples / fs / dt_scan, 2),
        "n_fixes": len([f for f in res.fixes if f.valid]),
        "compile_warmup_s": round(warm_s, 1),
        "profile_s": {k: round(v, 3) if isinstance(v, float) else v
                      for k, v in getattr(rx, "last_profile", {}).items()},
    }


def scaling_worker(n_devices: int, include_caf: bool = True) -> dict:
    """One weak-scaling point: the sharded detect+acquire chain
    (PSD/power fusion + non-coherent CAF acquisition) on an n-device mesh.

    Per-device workload is constant (_PER_DEVICE_SAMPLES), so perfect
    scaling = constant step time; efficiency = t(1) / t(N).
    """
    import jax
    import jax.numpy as jnp

    from ..config import DetectorConfig, SpectralConfig
    from ..ops import caf as caf_ops
    from ..ops import codes, cplx
    from ..parallel import fusion, mesh as mesh_lib

    devices = jax.devices()[:n_devices]
    n_ant = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_time = n_devices // n_ant
    mesh = mesh_lib.make_mesh(n_ant, n_time, devices=devices)

    det = DetectorConfig(power_chunk_samples=4096)
    spec = SpectralConfig(nperseg=1024)
    n_per_stream = _PER_DEVICE_SAMPLES * n_time
    rng = np.random.default_rng(0)
    streams = (rng.standard_normal((n_ant, n_per_stream))
               + 1j * rng.standard_normal((n_ant, n_per_stream))
               ).astype(np.complex64)
    blocks = jnp.asarray(fusion.shard_blocks(streams, n_ant, n_time, _BLOCK))

    fs = 2.048e6
    n_code = 2048                       # one C/A period at 2.048 MS/s
    on_cpu = jax.default_backend() == "cpu"
    n_prn = 8 if on_cpu else 32         # CPU-mesh plumbing stays quick
    dopp = caf_ops.doppler_bins(7000.0, 1000.0 if on_cpu else 200.0)
    rep = cplx.CArray(*codes.sampled_code_fft_conj_host(
        codes.gps_ca_table()[:n_prn], 1.023e6, fs, n_code))

    def step(b):
        psd_fused, psd_ant, pm = fusion.sharded_psd_and_power(
            b, mesh, fs, det, spec)
        return psd_fused.sum(), pm.sum()

    jstep = jax.jit(step)
    dt = _slope_time(jstep, blocks)
    out = {"n_devices": n_devices, "mesh": [n_ant, n_time]}
    if include_caf:
        # detect+acquire chain: CAF over 8 integration blocks per shard
        # (the sharded form of the flagship bench.py step)
        def chain(b):
            _, _, pm = fusion.sharded_psd_and_power(b, mesh, fs, det, spec)
            surf = fusion.sharded_caf_acquire(b, mesh, rep, dopp, fs)
            return pm.sum(), surf.max()

        dt_chain = _slope_time(jax.jit(chain), blocks)
        out["chain_step_s"] = round(dt_chain, 6)
        out["chain_msamples_per_s_per_device"] = round(
            n_ant * n_per_stream / dt_chain / 1e6 / n_devices, 2)
    total = n_ant * n_per_stream
    out.update(step_s=round(dt, 6),
               msamples_per_s=round(total / dt / 1e6, 2),
               msamples_per_s_per_device=round(
                   total / dt / 1e6 / n_devices, 2))
    return out


def weak_scaling(device_counts: list[int], platform: str = "cpu"
                 ) -> list[dict]:
    """Run scaling_worker in one subprocess per mesh size."""
    rows = []
    for n in device_counts:
        env = dict(os.environ)
        if platform == "cpu":
            env["JAX_PLATFORMS"] = "cpu"
            env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                                + f" --xla_force_host_platform_device_count={n}")
        code = ("import json;"
                "import jax; jax.config.update('jax_platforms', 'cpu');"
                if platform == "cpu" else "import json;") + (
                "from gps_jamming_tpu.runtime import benchmarks;"
                f"print('RESULT '+json.dumps(benchmarks.scaling_worker({n})))")
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=1200)
        line = [ln for ln in out.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if not line:
            rows.append({"n_devices": n, "error":
                         (out.stderr or out.stdout)[-400:]})
            continue
        rows.append(json.loads(line[0][len("RESULT "):]))
    base = next((r.get("msamples_per_s_per_device") for r in rows
                 if r.get("n_devices") == device_counts[0]
                 and "error" not in r), None)
    if base:
        for r in rows:
            if "error" not in r:
                r["weak_scaling_efficiency"] = round(
                    r["msamples_per_s_per_device"] / base, 3)
    if platform == "cpu":
        for r in rows:
            r["note"] = ("virtual CPU mesh: devices share one host's cores, "
                         "so efficiency measures host contention, not the "
                         "interconnect; use --platform gpu on multi-GPU "
                         "hardware")
    return rows
