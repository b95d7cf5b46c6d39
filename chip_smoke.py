#!/usr/bin/env python3
"""Drive the detect/receiver product path once on an NVIDIA GPU and check it.

    python chip_smoke.py              # one GPU: kernels + product path
    python chip_smoke.py --devices 4  # four GPUs: sharded detect only

Phases; every check prints PASS or FAIL on its own line:
  a. device: refuses anything but a GPU, prints the card, its power limit
     and the compile cache directory;
  b. kernels at deployment widths against the plain float64 reference
     (`ops/reference.py`, scipy), at the default matmul precision and at
     "highest": max error, bound, XLA time and `memory_analysis()`;
  c. the product path through `gps_jamming_tpu.cli.main`: a GPS station
     (24 s), a jammed 3-antenna site (8 s), Galileo and GLONASS monitors
     (8 s each), each run twice (cold, then with compiled programs cached);
  d. `--devices 4` only: `detect --devices 4` on a 2-antenna capture set
     against the same analysis on one device.

Captures are simulated from fixed seeds into a temporary directory. The
last stdout line is one JSON object, printed only when every check passed:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

# deployment sizes (the reference's front ends and channel plans)
GPS_FS, GAL_FS, GLO_FS = 2.048e6, 4.096e6, 10e6
GPS_STATION_S = 24.0          # 6 segments of 4 s: several PVT epochs
MONITOR_S = 8.0               # Galileo / GLONASS monitors
JAM_SITE_S = 8.0              # jammed 3-antenna site, chirp 3..5 s
JAM_START_S, JAM_DUR_S = 3.0, 2.0
SEGMENT_S = 4.0               # the streaming receiver's default segment
CHUNK_S = 32768 / GPS_FS      # detector chunk, 16 ms
PSD_SAMPLES = 1 << 19
INGEST_BYTES = 1 << 20
TIMING_REPS = 10

# bounds: float32 against float64 at "highest"; TF32 headroom at default
CAF_TOL = {"highest": 1e-5, "default": 2e-3}
PSD_RTOL = 1e-4
TRACK_TOL = {"carr_hz": 1.0, "code_chips": 0.02, "cn0_db": 0.5}
FIX_TOL_M = 30.0              # tests/test_rx_stream.py median-fix bound
# RSSI ranges from the mean amplitude to end of file, so the 3 s noise tail
# after the jam overestimates every distance (reference behaviour)
RSSI_TOL_M = 5.0
SHARD_RTOL = 1e-5

FAILED: list[str] = []


def log(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, ok: bool, detail: str) -> bool:
    log(f"[{'PASS' if ok else 'FAIL'}] {name}: {detail}")
    if not ok:
        FAILED.append(name)
    return ok


def require_gpu(devices, n: int = 1):
    """The first n devices, if they are GPUs; SystemExit otherwise."""
    plat = devices[0].platform if devices else "none"
    if plat != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {plat!r}")
    if len(devices) < n:
        raise SystemExit(f"chip_smoke: needs {n} GPUs, found "
                         f"{len(devices)}")
    return list(devices[:n])


def _cli(argv) -> dict:
    """Run one CLI verb in this process; return its JSON output."""
    from gps_jamming_tpu import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} exited {rc}")
    return json.loads(buf.getvalue())


def _precision(p: str):
    import jax
    return (contextlib.nullcontext() if p == "default"
            else jax.default_matmul_precision(p))


def _compile(fn, args, precision: str = "default"):
    """jit + lower + compile at a matmul precision; (compiled, seconds)."""
    import jax
    t0 = time.perf_counter()
    with _precision(precision):
        c = jax.jit(fn).lower(*args).compile()
    return c, time.perf_counter() - t0


def _mem(c) -> str:
    m = c.memory_analysis()
    if m is None:
        return "memory_analysis: n/a"
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return "memory_analysis: " + ", ".join(
        f"{k.replace('_size_in_bytes', '')}={getattr(m, k, 0) / 2**20:.1f}"
        "MiB" for k in keys)


def _time(c, args, reps: int = TIMING_REPS) -> float:
    """Median seconds per call of a compiled program (device-synchronized)."""
    import jax
    jax.block_until_ready(c(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(c(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _write_capture(path: str, sig: np.ndarray) -> None:
    from gps_jamming_tpu.ops import iq
    # the sims are ~unit amplitude: scale into the uint8 ADC range
    iq.write_iq_file(path, (sig * 12.0).astype(np.complex64))


def _read_blocks(path: str, n_blocks: int, n: int, offset: int = 0):
    from gps_jamming_tpu.ops import cplx, iq
    x = iq.read_iq_file(path, convention="centered",
                        count=2 * n_blocks * n, offset_bytes=2 * offset)
    x = x.reshape(n_blocks, n)
    return cplx.CArray(np.ascontiguousarray(x.real, np.float32),
                       np.ascontiguousarray(x.imag, np.float32))


# ---------------------------------------------------------------------------
# a. device
# ---------------------------------------------------------------------------

def phase_device(n_devices: int):
    import jax

    from gps_jamming_tpu.runtime.compile_cache import cache_dir
    devs = require_gpu(jax.devices(), n_devices)
    log(f"device: {devs[0].platform} {devs[0].device_kind} "
        f"x{len(jax.devices())}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    for line in smi.stdout.strip().splitlines():
        log(f"nvidia-smi: {line}")
    d = cache_dir()
    n_cached = len(os.listdir(d)) if os.path.isdir(d) else 0
    log(f"compile cache: {d} ({n_cached} entries at start)")
    return devs


# ---------------------------------------------------------------------------
# b. kernels against the plain reference
# ---------------------------------------------------------------------------

def _caf_check(name, fn, args, ref, freqs, cfg, code_period_s,
               code_len_chips, fs, truth_ids=None):
    """Compile fn at default and highest precision; compare with the float64
    reference surface and the acquisition decisions."""
    from gps_jamming_tpu.models.receiver import acquisition as acq_mod
    from gps_jamming_tpu.ops import reference as R
    import jax
    import jax.numpy as jnp

    want = R.checkacquisition_np(ref, freqs, cfg.peak_ratio_threshold,
                                 cfg.exclude_chips, code_period_s,
                                 code_len_chips)
    acq_ref = want["acquired"]
    test = jax.jit(lambda s: acq_mod.acquisition_test(
        s, jnp.asarray(freqs), fs, cfg, code_period_s, code_len_chips))
    times = {}
    for prec in ("default", "highest"):
        c, t_comp = _compile(fn, args, prec)
        log(f"{name} [{prec}] compile {t_comp:.2f} s; {_mem(c)}")
        surf = np.asarray(c(*args))
        times[prec] = _time(c, args)
        err = float(np.max(np.abs(surf - ref)) / np.max(ref))
        check(f"{name} surface [{prec}]", err <= CAF_TOL[prec],
              f"max|d|/max(ref) = {err:.3e} <= {CAF_TOL[prec]:.0e} "
              f"(precision {prec}; XLA {times[prec] * 1e3:.3f} ms)")
        got = jax.tree_util.tree_map(np.asarray, test(surf))
        d_idx = np.argmax(got.doppler_hz[:, None]
                          == np.asarray(freqs, np.float32)[None, :], axis=1)
        same = (np.array_equal(got.acquired, acq_ref)
                and np.array_equal(got.code_phase[acq_ref],
                                   want["code_phase"][acq_ref])
                and np.array_equal(d_idx[acq_ref],
                                   want["doppler_index"][acq_ref]))
        check(f"{name} decisions [{prec}]", bool(same),
              f"acquired {int(acq_ref.sum())}/{acq_ref.size} identical "
              "to the float64 reference (flag, code phase, Doppler index)")
    log(f"{name}: pin cost highest/default = "
        f"{times['highest'] / times['default']:.3f}x")
    if truth_ids is not None:
        log(f"{name}: acquired ids {sorted(np.flatnonzero(acq_ref).tolist())}"
            f"; simulated {sorted(truth_ids)}")
    return times


def phase_kernels(ctx: dict) -> None:
    import jax
    import jax.numpy as jnp
    from scipy import signal as ss

    from gps_jamming_tpu.config import AcquisitionConfig
    from gps_jamming_tpu.models.receiver import galileo as gal
    from gps_jamming_tpu.models.receiver import glonass as glo
    from gps_jamming_tpu.ops import caf, cplx, iq, spectral
    from gps_jamming_tpu.ops import reference as R
    from gps_jamming_tpu.runtime import rx_stream

    cfg = ctx.get("acq_cfg") or AcquisitionConfig()

    # -- ingest: int8 deinterleave must stay exact -------------------------
    raw_u8 = np.fromfile(ctx["gps_path"], np.uint8, count=INGEST_BYTES)
    x8 = iq.uint8_np_to_int8(raw_u8)
    for conv, off in (("centered", 0.5), ("int8", 0.0)):
        c, t_comp = _compile(lambda r, cv=conv: iq.int8_to_planar(
            r, convention=cv), (x8,))
        got = c(x8)
        re_w = x8[0::2].astype(np.float32) + np.float32(off)
        im_w = x8[1::2].astype(np.float32) + np.float32(off)
        ok = (np.array_equal(np.asarray(got.re), re_w)
              and np.array_equal(np.asarray(got.im), im_w))
        check(f"ingest int8_to_planar [{conv}]", ok,
              f"{INGEST_BYTES} bytes bitwise equal to the NumPy split "
              f"(precision default; XLA {_time(c, (x8,)) * 1e6:.1f} us; "
              f"compile {t_comp:.2f} s; {_mem(c)})")

    # -- Welch PSD: 512k samples through the jammed band --------------------
    xs = _read_blocks(ctx["jam_paths"][0], 1, PSD_SAMPLES,
                      offset=int((JAM_START_S + 0.5) * GPS_FS))
    xs = cplx.CArray(xs.re[0], xs.im[0])
    c, t_comp = _compile(lambda r, i: spectral.welch_psd_p(
        cplx.CArray(r, i), GPS_FS, 1024), (xs.re, xs.im))
    got = np.asarray(c(xs.re, xs.im))
    _, want = ss.welch(xs.re.astype(np.float64) + 1j * xs.im, GPS_FS,
                       nperseg=1024, return_onesided=False)
    rel = float(np.max(np.abs(got - want) / want))
    check("welch_psd_p", rel <= PSD_RTOL,
          f"max rel |d| = {rel:.3e} <= {PSD_RTOL:.0e} vs scipy float64 "
          f"(precision default; XLA {_time(c, (xs.re, xs.im)) * 1e3:.3f} ms; "
          f"compile {t_comp:.2f} s; {_mem(c)})")

    # -- GPS PCF acquisition: 32 PRN x 10 periods x 2048 lags ---------------
    rx = rx_stream.StreamingReceiver(GPS_FS, system="gps",
                                     segment_s=SEGMENT_S)
    rep = rx.su["replica"]
    blk = _read_blocks(ctx["gps_path"], cfg.n_integration, rx.su["n_code"])
    ref = R.caf_accumulate_pcf_np(blk, rep, GPS_FS, cfg.doppler_max_hz)
    freqs = caf.pcf_doppler_hz(GPS_FS, rx.su["n_code"], cfg.doppler_max_hz)
    ctx["times"]["caf_gps_pcf"] = _caf_check(
        "caf_accumulate_pcf GPS", lambda r, i: caf.caf_accumulate_pcf(
            cplx.CArray(r, i), rep, GPS_FS,
            max_doppler_hz=cfg.doppler_max_hz), (blk.re, blk.im), ref,
        freqs, cfg, 1e-3 * (cfg.n_integration // 2), 1023.0, GPS_FS,
        truth_ids=[t.prn - 1 for t in ctx["gps_truths"]])

    # -- GLONASS FDMA PCF: 14 channels x 10 periods x 10000 lags ------------
    n_glo = int(round(GLO_FS * 1e-3))
    grep = glo.replica_table_host(GLO_FS, n_glo)
    offs = glo.channel_offsets_hz()
    blk = _read_blocks(ctx["glo_path"], cfg.n_integration, n_glo)
    ref = R.caf_accumulate_pcf_fdma_np(blk, grep, offs, GLO_FS,
                                       cfg.doppler_max_hz)
    freqs = caf.pcf_doppler_hz(GLO_FS, n_glo, cfg.doppler_max_hz)
    ctx["times"]["caf_glonass_fdma"] = _caf_check(
        "caf_accumulate_pcf_fdma GLONASS",
        lambda r, i: caf.caf_accumulate_pcf_fdma(
            cplx.CArray(r, i), grep, offs, GLO_FS,
            max_doppler_hz=cfg.doppler_max_hz), (blk.re, blk.im), ref,
        freqs, cfg, 1e-3 * (cfg.n_integration // 2), 511.0, GLO_FS,
        truth_ids=[glo.FREQ_CHANNELS.index(t.prn)
                   for t in ctx["glo_truths"]])

    # -- Galileo E1B: both searches at 16384 lags --------------------------
    rxg = rx_stream.StreamingReceiver(GAL_FS, system="galileo")
    n_gal = rxg.su["n_code"]
    dopp = caf.doppler_bins(cfg.doppler_max_hz, cfg.doppler_step_hz)
    pcf_auto = caf.pcf_profitable(n_gal, cfg.n_integration, GAL_FS,
                                  cfg.doppler_max_hz, dopp.size)
    log(f"Galileo: method='auto' picks {'pcf' if pcf_auto else 'std'} "
        f"for {cfg.n_integration} blocks of {n_gal}")
    grep_e = rxg.su["replica"]
    gal_ids = [t.prn - 1 for t in ctx["gal_truths"]]
    blk = _read_blocks(ctx["gal_path"], cfg.n_integration, n_gal)
    ref = R.caf_accumulate_np(blk, grep_e, dopp, GAL_FS)
    ctx["times"]["caf_galileo_std"] = _caf_check(
        "caf_accumulate Galileo", lambda r, i: caf.caf_accumulate(
            cplx.CArray(r, i), grep_e, dopp, GAL_FS), (blk.re, blk.im),
        ref, dopp, cfg, gal.PERIOD_S, float(gal.BOC_LEN), GAL_FS,
        truth_ids=gal_ids)
    ref = R.caf_accumulate_pcf_np(blk, grep_e, GAL_FS, cfg.doppler_max_hz)
    ctx["times"]["caf_galileo_pcf"] = _caf_check(
        "caf_accumulate_pcf Galileo", lambda r, i: caf.caf_accumulate_pcf(
            cplx.CArray(r, i), grep_e, GAL_FS,
            max_doppler_hz=cfg.doppler_max_hz), (blk.re, blk.im), ref,
        caf.pcf_doppler_hz(GAL_FS, n_gal, cfg.doppler_max_hz), cfg,
        gal.PERIOD_S * (cfg.n_integration // 2), float(gal.BOC_LEN),
        GAL_FS, truth_ids=gal_ids)

    # -- tracking: one 4 s GPS segment, full 32-slot plan -------------------
    _tracking_check(ctx, rx)


def _tracking_check(ctx: dict, rx) -> None:
    import jax
    import jax.numpy as jnp

    from gps_jamming_tpu.models.receiver import tracking
    from gps_jamming_tpu.ops import codes

    truths = sorted(ctx["gps_truths"], key=lambda t: t.prn)[:rx.n_slots]
    live = [t.prn for t in truths]
    prns = live + [p for p in range(1, 33) if p not in live]
    prns = prns[:rx.n_slots]
    cps = rx.su["chip_rate"] / GPS_FS
    lag = np.zeros(rx.n_slots, np.float32)
    dop = np.zeros(rx.n_slots, np.float32)
    for i, t in enumerate(truths):
        lag[i] = ((1023.0 - t.code_phase_chips) % 1023.0) / cps
        dop[i] = t.doppler_hz
    st = tracking.init_state(rx.n_slots, dop, lag, GPS_FS,
                             code_len=rx.su["code_len"],
                             chip_rate=rx.su["chip_rate"])
    tab = np.stack([codes.gps_ca_code(p) for p in prns]).astype(np.float32)
    W = rx.segment_window_samples()
    xw = _read_blocks(ctx["gps_path"], 1, W)
    xw = type(xw)(jnp.asarray(xw.re[0]), jnp.asarray(xw.im[0]))
    args = (st, xw, jnp.zeros((2, rx.n_slots), jnp.int32), jnp.asarray(tab),
            jnp.full(rx.n_slots, 1575.42e6, jnp.float32),
            jnp.zeros(rx.n_slots, jnp.float32))
    outs = {}
    times = {}
    for prec in ("default", "highest"):
        t0 = time.perf_counter()
        with _precision(prec):
            c = rx._jit_run.lower(*args).compile()
        log(f"tracking scan [{prec}] compile "
            f"{time.perf_counter() - t0:.2f} s; {_mem(c)}")
        _, packed = c(*args)
        outs[prec] = np.asarray(packed)[:, -1]      # (4, n_slots) last epoch
        times[prec] = _time(c, args, reps=3)
    ctx["times"]["tracking_scan_4s"] = times
    k = len(truths)
    hi, lo = outs["highest"], outs["default"]
    locked = hi[3, :k] > 35.0
    check("tracking lock", int(locked.sum()) >= 4,
          f"{int(locked.sum())}/{k} simulated satellites above 35 dB-Hz "
          "after one segment")
    d_f = np.abs(lo[2, :k] - hi[2, :k])[locked]
    d_c = np.abs((lo[1, :k] - hi[1, :k] + 511.5) % 1023.0 - 511.5)[locked]
    d_n = np.abs(lo[3, :k] - hi[3, :k])[locked]
    check("tracking default vs highest",
          bool(d_f.max(initial=0) <= TRACK_TOL["carr_hz"]
               and d_c.max(initial=0) <= TRACK_TOL["code_chips"]
               and d_n.max(initial=0) <= TRACK_TOL["cn0_db"]),
          f"carrier {d_f.max(initial=0):.3e} Hz (<= 1), code "
          f"{d_c.max(initial=0):.3e} chip (<= 0.02), C/N0 "
          f"{d_n.max(initial=0):.3e} dB (<= 0.5); XLA scan "
          f"{times['default'] * 1e3:.1f} ms default, "
          f"{times['highest'] * 1e3:.1f} ms highest per 4 s segment")


# ---------------------------------------------------------------------------
# c. product path
# ---------------------------------------------------------------------------

def _timed_twice(name: str, argv, capture_s: float):
    """Run a verb cold then warm; print wall and realtime of both."""
    walls, outs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        outs.append(_cli(argv))
        walls.append(time.perf_counter() - t0)
    log(f"{name}: wall {walls[0]:.2f} s cold (compile included, "
        f"{capture_s / walls[0]:.2f}x realtime), {walls[1]:.2f} s warm "
        f"(compiled programs cached, {capture_s / walls[1]:.2f}x realtime) "
        f"over {capture_s:.0f} s of capture")
    return outs


def _processed_s(seconds: float, fs: float, n_code: int) -> float:
    """Capture seconds the streaming receiver covers (whole segments)."""
    return ((int(seconds * fs) - n_code) // int(SEGMENT_S * fs)) * SEGMENT_S


def phase_product(ctx: dict) -> None:
    from gps_jamming_tpu.models.receiver import pvt
    from gps_jamming_tpu.models.receiver import glonass as glo

    # -- GPS station ---------------------------------------------------------
    outs = _timed_twice(
        "GPS station receiver --streaming",
        ["receiver", ctx["gps_path"], "--streaming", "--segment-seconds",
         SEGMENT_S],
        _processed_s(GPS_STATION_S, GPS_FS, 2048))
    out = outs[0]
    fix = out["fix"]
    err = (float(np.linalg.norm(pvt.lla_to_ecef(fix["lat"], fix["lon"],
                                                fix["hgt"])
                                - ctx["gps_rx_ecef"]))
           if fix else float("inf"))
    check("GPS station fix", fix is not None and err <= FIX_TOL_M,
          f"{out['n_fixes']} valid fixes, best-fix error {err:.2f} m "
          f"(<= {FIX_TOL_M:.0f} m), acquired "
          f"{len(out['acquired'])}, decoded {len(out['decoded_prns'])}")
    check("GPS station repeatable", outs[1]["fix"] == fix,
          "warm run gives the same fix")

    # -- jammed 3-antenna site ----------------------------------------------
    outs = _timed_twice("jammed site detect (3 antennas)",
                        ["detect", *ctx["jam_paths"]], JAM_SITE_S)
    out = outs[0]
    ev = out["events"]
    onset = ev[0]["start_time"] if ev else float("nan")
    check("jam event", len(ev) == 1
          and abs(onset - JAM_START_S) <= CHUNK_S,
          f"{len(ev)} event(s), onset {onset:.4f} s vs {JAM_START_S} s "
          f"(<= one {CHUNK_S * 1e3:.0f} ms chunk)")
    loc = out["localization"] or {}
    pos = loc.get("location_meters")
    d_pos = (float(np.hypot(pos[0] - ctx["jammer_m"][0],
                            pos[1] - ctx["jammer_m"][1]))
             if pos else float("inf"))
    check("RSSI localization", bool(loc.get("success"))
          and d_pos <= RSSI_TOL_M,
          f"{loc.get('message')}; {d_pos:.2f} m from the simulated jammer "
          f"{ctx['jammer_m']} (<= {RSSI_TOL_M:.0f} m); distances "
          f"{loc.get('distances')}")
    td = out["tdoa"] or {}
    check("TDOA output", len(td.get("pairs") or []) == 3,
          f"{len(td.get('pairs') or [])} antenna pairs, position "
          f"{td.get('position_m')}")

    # -- Galileo and GLONASS monitors ---------------------------------------
    for system, path, fs, truths, n_code, ids in (
            ("galileo", ctx["gal_path"], GAL_FS, ctx["gal_truths"],
             16384, None),
            ("glonass", ctx["glo_path"], GLO_FS, ctx["glo_truths"],
             10000, glo.FREQ_CHANNELS)):
        outs = _timed_twice(
            f"{system} monitor receiver --streaming",
            ["receiver", path, "--system", system, "--sample-rate", fs,
             "--streaming", "--segment-seconds", SEGMENT_S],
            _processed_s(MONITOR_S, fs, n_code))
        out = outs[0]
        acq = {a["prn"] for a in out["acquired"]}
        sim = {t.prn for t in truths}
        trk = {int(k): v for k, v in out["tracked_s"].items()}
        short = [p for p in sim if trk.get(p, 0.0) < 0.9 * SEGMENT_S]
        check(f"{system} monitor", sim <= acq and not short,
              f"simulated {sorted(sim)}; acquired {sorted(acq)}; "
              f"tracked seconds {trk}")


# ---------------------------------------------------------------------------
# d. four GPUs: sharded detect vs one device
# ---------------------------------------------------------------------------

def phase_sharded(ctx: dict, devs) -> None:
    import itertools

    import jax
    import jax.numpy as jnp

    from gps_jamming_tpu.config import DEFAULT_CONFIG as CFG
    from gps_jamming_tpu.models import detector
    from gps_jamming_tpu.ops import cplx, fftcore, spectral
    from gps_jamming_tpu.ops import power as power_ops
    from gps_jamming_tpu.parallel import fusion, mesh as mesh_lib
    from gps_jamming_tpu.runtime import sharded

    paths = ctx["pair_paths"]
    t0 = time.perf_counter()
    out = _cli(["detect", *paths, "--devices", len(devs)])
    log(f"detect --devices {len(devs)}: wall {time.perf_counter() - t0:.2f}"
        f" s, mesh {out['mesh']}")
    n_ant = len(paths)
    n_time = len(devs) // n_ant
    check("mesh", out["mesh"] == {"antenna": n_ant, "time": n_time,
                                  "devices": len(devs)}, str(out["mesh"]))

    chunk = CFG.detector.power_chunk_samples
    n = min(os.path.getsize(p) // 2 for p in paths)
    L = (n // (n_time * chunk)) * chunk
    caps = [sharded._load_planar(p, L * n_time) for p in paths]
    one = jax.devices()[0]

    # single-device analysis of the same samples
    with jax.default_device(one):
        pms, psds = [], []
        for i, c in enumerate(caps):
            x = jnp.asarray(c.re) + 1j * jnp.asarray(c.im)
            prof = detector.power_profile(x, CFG.detector)
            ranges = detector.power_profile_ranges(prof, CFG.detector)
            got = out["per_antenna"][i]
            ranges = [list(r) for r in ranges]
            check(f"antenna {i} events", got["power_ranges_bytes"] == ranges,
                  f"{got['power_ranges_bytes']} vs one device {ranges}")
            for key, want in (("baseline", prof.baseline),
                              ("threshold", prof.threshold)):
                w = float(np.asarray(want))
                check(f"antenna {i} {key}",
                      abs(got[key] - w) <= SHARD_RTOL * abs(w),
                      f"{got[key]:.9g} vs {w:.9g} (rtol {SHARD_RTOL:.0e})")
            xp = cplx.CArray(jnp.asarray(c.re), jnp.asarray(c.im))
            psds.append(np.asarray(spectral.welch_psd_p(
                xp, CFG.frontend.sample_rate_hz, CFG.spectral.nperseg)))
            pms.append(np.asarray(power_ops.chunk_power_p(xp, chunk)))
        psd1 = np.mean(psds, axis=0)
        peak_db = float(10.0 * np.log10(psd1.max()))
        check("fused PSD peak", abs(10 ** (out["psd_fused_peak_db"] / 10)
                                    - psd1.max())
              <= SHARD_RTOL * psd1.max(),
              f"{out['psd_fused_peak_db']:.6f} dB vs one device "
              f"{peak_db:.6f} dB")
        # TDOA argmax lags at the first onset (sharded.SLICE_LEN slices)
        r0 = out["per_antenna"][0]["power_ranges_bytes"]
        start = min(r0[0][0] // 2 if r0 else 0,
                    L * n_time - sharded.SLICE_LEN)
        sl = cplx.CArray(
            jnp.asarray(np.stack([c.re[start:start + sharded.SLICE_LEN]
                                  for c in caps])),
            jnp.asarray(np.stack([c.im[start:start + sharded.SLICE_LEN]
                                  for c in caps])))
        F = fftcore.fft_p(sl, n=2 * sharded.SLICE_LEN)
        for k, (i, j) in enumerate(itertools.combinations(range(n_ant), 2)):
            xc = np.asarray(fftcore.ifft_power_p(cplx.mul_conj(F[i], F[j])))
            lag = int(xc.argmax())
            lag = lag - xc.size if lag > xc.size // 2 else lag
            got = out["tdoa_pairs"][k]["lag_samples"]
            check(f"TDOA pair {i}-{j} lag", got == lag,
                  f"{got} vs one device {lag}")

    # the fused PSD and power arrays themselves, on the same mesh
    mesh = mesh_lib.make_mesh(n_ant, n_time, devices=devs)
    blocks = cplx.CArray(
        np.stack([c.re.reshape(n_time, L) for c in caps]),
        np.stack([c.im.reshape(n_time, L) for c in caps]))
    psd_f, _, pm = fusion.sharded_psd_and_power(
        blocks, mesh, CFG.frontend.sample_rate_hz, CFG.detector,
        CFG.spectral)
    rel_psd = float(np.max(np.abs(np.asarray(psd_f) - psd1) / psd1))
    pm1 = np.stack(pms)
    rel_pm = float(np.max(np.abs(np.asarray(pm) - pm1) / pm1))
    check("sharded PSD array", rel_psd <= SHARD_RTOL,
          f"max rel |d| {rel_psd:.3e} (rtol {SHARD_RTOL:.0e})")
    check("sharded power array", rel_pm <= SHARD_RTOL,
          f"max rel |d| {rel_pm:.3e} (rtol {SHARD_RTOL:.0e})")


# ---------------------------------------------------------------------------
# captures
# ---------------------------------------------------------------------------

def make_captures(d: str, sharded_only: bool) -> dict:
    from gps_jamming_tpu.runtime import benchmarks
    ctx: dict = {"times": {}}
    t0 = time.perf_counter()
    if sharded_only:
        prefix = os.path.join(d, "pair")
        res = _cli(["simulate", "--kind", "chirp", "--antennas", 2,
                    "--seconds", JAM_SITE_S, "--start", JAM_START_S,
                    "--duration", JAM_DUR_S, "--positions", "0,0;3,0",
                    "--out", prefix])
        ctx["pair_paths"] = res["written"]
    else:
        for key, system, secs in (("gps", "gps", GPS_STATION_S),
                                  ("gal", "galileo", MONITOR_S),
                                  ("glo", "glonass", MONITOR_S)):
            sig, _, truths, rx_ecef = benchmarks._bench_capture(system, secs)
            path = os.path.join(d, f"{system}.bin")
            _write_capture(path, sig)
            del sig
            ctx[f"{key}_path"] = path
            ctx[f"{key}_truths"] = truths
            ctx[f"{key}_rx_ecef"] = rx_ecef
        prefix = os.path.join(d, "jam")
        # no GPS background: under it the reference's TDOA onset rule
        # (50x the noise floor) cannot fire below ADC saturation
        res = _cli(["simulate", "--kind", "chirp", "--antennas", 3,
                    "--seconds", JAM_SITE_S, "--start", JAM_START_S,
                    "--duration", JAM_DUR_S, "--out", prefix])
        ctx["jam_paths"] = res["written"]
        ctx["jammer_m"] = res["scenario"]["jammer_m"]
    log(f"captures simulated in {time.perf_counter() - t0:.1f} s (host)")
    return ctx


def _run_phase(name: str, fn, *args) -> None:
    t0 = time.perf_counter()
    try:
        fn(*args)
    except Exception:                  # recorded: the run exits non-zero
        traceback.print_exc()
        check(f"phase {name}", False, "raised (traceback on stderr)")
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=[1, 4], default=1,
                    help="4 = run only the sharded detect phase on four "
                         "GPUs")
    args = ap.parse_args(argv)

    from gps_jamming_tpu.runtime.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax

    devs = phase_device(args.devices)
    with tempfile.TemporaryDirectory() as d:
        ctx = make_captures(d, sharded_only=args.devices > 1)
        if args.devices > 1:
            _run_phase("d (sharded detect)", phase_sharded, ctx, devs)
        else:
            _run_phase("b (kernels)", phase_kernels, ctx)
            _run_phase("c (product path)", phase_product, ctx)
    log(f"XLA times (s, median): {json.dumps(ctx['times'])}")
    from gps_jamming_tpu.runtime.compile_cache import cache_dir
    d = cache_dir()
    log(f"compile cache: {d} "
        f"({len(os.listdir(d)) if os.path.isdir(d) else 0} entries at end)")
    if FAILED:
        log(f"FAILED: {FAILED}")
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
