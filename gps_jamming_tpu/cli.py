"""Command-line interface: detect / localize / simulate / spectrum /
calibrate / receiver verbs.

The product edge (SURVEY.md §7 M5): replaces the reference's GUI-driven
workflow (app.py + worker.py) and its CLI twins (`checkIfJamming.py`,
`skrypty/*.py`, `gnssdec` flags, simulate/frontend) with one entry point:

    python -m gps_jamming_tpu detect capture.bin [ant2.bin ant3.bin]
    python -m gps_jamming_tpu localize a0.bin a1.bin a2.bin --positions ...
    python -m gps_jamming_tpu simulate --kind chirp --out ant --seconds 1
    python -m gps_jamming_tpu spectrum capture.bin --out psd.csv
    python -m gps_jamming_tpu calibrate capture.bin
    python -m gps_jamming_tpu receiver capture.bin [--system galileo]
    python -m gps_jamming_tpu report a0.bin a1.bin a2.bin --out report/
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _wire_bits(s: str):
    """argparse type for --wire-bits: 'auto' or an int width."""
    return s if s == "auto" else int(s)


def _parse_positions(spec: str | None, n: int):
    """--positions "x1,y1;x2,y2;..." -> [(x, y), ...]."""
    if spec is None:
        # default antenna square (settings_dialog.py defaults)
        defaults = [(0.0, 0.0), (3.0, 0.0), (0.0, 3.0)]
        return defaults[:n]
    out = []
    for part in spec.split(";"):
        x, y = part.split(",")
        out.append((float(x), float(y)))
    return out


def _config_with_overrides(args):
    """Apply settings-dialog-style CLI overrides (settings_dialog.py:47-120)
    onto the default config tree."""
    import dataclasses

    from .config import DEFAULT_CONFIG
    cfg = DEFAULT_CONFIG
    thr = getattr(args, "threshold_db", None)
    if thr is not None:
        cfg = dataclasses.replace(
            cfg, detector=dataclasses.replace(cfg.detector,
                                              power_rise_db=float(thr)))
    return cfg


def cmd_detect(args) -> int:
    from .runtime import pipeline
    if args.devices:
        # sharded product path: psum/all_gather fusion over an
        # ('antenna', 'time') mesh — numerically identical to the
        # single-device kernels (tests/test_sharded_detect.py).
        # Flags of the serial receiver pipeline don't apply here: reject
        # loudly instead of silently ignoring them.
        unsupported = [name for name, bad in [
            ("--checkpoint", args.checkpoint),
            ("--resume", args.resume),
            ("--hold", args.hold),
            ("--filter ekf", args.filter != "wls"),
            ("--batch-receiver", args.batch_receiver),
            ("--wire-bits", args.wire_bits != "auto"),
            ("--no-receiver", args.no_receiver),
            ("--no-localize", args.no_localize),
            ("--telemetry-out", args.telemetry_out),
            ("--positions", args.positions)] if bad]
        if unsupported:
            print("--devices runs the sharded power/PSD/acquisition/"
                  f"TDOA analysis; not supported there: "
                  f"{', '.join(unsupported)}", file=sys.stderr)
            return 2
        from .runtime import sharded
        out = sharded.analyze_capture_sharded(
            args.files, n_devices=args.devices,
            cfg=_config_with_overrides(args), system=args.system,
            sample_rate=args.sample_rate, max_seconds=args.max_seconds)
        print(json.dumps(out, default=_np_default, indent=2))
        return 0
    positions = _parse_positions(args.positions, len(args.files))
    res = pipeline.analyze_capture(
        args.files, antenna_positions=positions,
        cfg=_config_with_overrides(args),
        run_receiver=not args.no_receiver, localize=not args.no_localize,
        max_seconds=args.max_seconds, system=args.system, hold=args.hold,
        sample_rate=args.sample_rate, pvt_filter=args.filter,
        streaming=not args.batch_receiver, wire_bits=args.wire_bits,
        checkpoint_path=args.checkpoint, resume=args.resume)
    out = {
        "power_ranges_bytes": res.power_ranges,
        "events": res.events,
        "n_events": len(res.events),
        "localization": res.localization,
        "tdoa": {k: v for k, v in (res.tdoa_result or {}).items()
                 if k != "onsets"} if res.tdoa_result else None,
        "last_safe_fix": res.last_safe_fix,
        "elapsed_s": round(res.elapsed_s, 2),
    }
    if res.receiver is not None:
        fix = res.receiver.best_fix
        out["fix"] = None if fix is None else {
            "lat": fix.lat_deg, "lon": fix.lon_deg, "hgt": fix.height_m,
            "gdop": fix.gdop, "nsat": fix.nsat}
        out["acquired_prns"] = [c.prn for c in res.receiver.channels
                                if c.acquired]
    print(json.dumps(out, default=_np_default, indent=2))
    if args.telemetry_out:
        res.telemetry.save_jsonl(args.telemetry_out)
    return 0


def cmd_localize(args) -> int:
    import jax.numpy as jnp

    from .config import DEFAULT_CONFIG as CFG
    from .models import rssi, tdoa
    from .ops import iq
    positions = _parse_positions(args.positions, len(args.files))
    caps = [(iq.read_iq_file(p, convention="normalized"))
            for p in args.files]
    res = rssi.triangulate(caps, positions, cfg=CFG.rssi)
    out = {"rssi": res}
    if not args.no_tdoa and len(args.files) >= 2:
        caps_c = [(iq.read_iq_file(p, convention="centered"))
                  for p in args.files]
        td = tdoa.localize(caps_c, positions,
                           args.sample_rate or CFG.frontend.sample_rate_hz,
                           cfg=CFG.tdoa)
        td.pop("onsets", None)
        out["tdoa"] = td
    print(json.dumps(out, default=_np_default, indent=2))
    return 0


def cmd_simulate(args) -> int:
    """The reference sim GUI's three modes (gnss_frontend.py:791-1307):
    --kind clean = mode A (weakened GPS), cw/chirp/broadband/pulsed =
    mode B (jammer, optionally --with-gps over a live constellation),
    spoof = mode C (spoofer)."""
    from .sim import scenario
    fs = args.sample_rate
    n = int(args.seconds * fs)
    lla = (args.lat, args.lon, args.hgt)
    paths = [f"{args.out}{i}.bin" for i in range(args.antennas)]

    if args.kind == "clean":
        end_lla = None
        if (args.end_lat is not None or args.end_lon is not None
                or args.end_hgt is not None):
            end_lla = (args.end_lat if args.end_lat is not None
                       else args.lat,
                       args.end_lon if args.end_lon is not None
                       else args.lon,
                       args.end_hgt if args.end_hgt is not None
                       else args.hgt)
        for i, path in enumerate(paths):
            scenario.write_clean_capture(
                path, lla, n, fs, weaken_gps=not args.no_weaken,
                seed=args.seed + i, end_lla=end_lla)
        print(json.dumps({"written": paths, "scenario": {
            "kind": "clean", "lla": list(lla),
            **({"end_lla": list(end_lla)} if end_lla else {}),
            "weakened": not args.no_weaken}}))
        return 0

    if args.kind == "spoof":
        fake_lla = (args.spoof_lat, args.spoof_lon, args.spoof_hgt)
        for i, path in enumerate(paths):
            fake_ecef = scenario.write_spoof_capture(
                path, lla, fake_lla, n, fs, start_s=args.start,
                ramp_s=args.ramp, overpower=args.overpower,
                seed=args.seed + i)
        print(json.dumps({"written": paths, "scenario": {
            "kind": "spoof", "true_lla": list(lla),
            "fake_lla": list(fake_lla), "fake_ecef": list(fake_ecef),
            "start_s": args.start, "overpower": args.overpower}},
            default=_np_default))
        return 0

    background = None
    if args.with_gps:
        import jax.numpy as jnp

        from .sim import mix
        bg, _, _ = scenario.gps_background(
            lla, scenario.DEFAULT_TOE_S - 1.3, n, fs, seed=args.seed)
        # x0.125 GPS level; AWGN is added per antenna downstream
        background = mix.weaken(jnp.asarray(bg), noise_std=0.0)
    scn = scenario.JammerScenario(
        kind=args.kind, position_m=(args.jammer_x, args.jammer_y),
        start_s=args.start, duration_s=args.duration, seed=args.seed)
    positions = _parse_positions(args.positions, args.antennas)
    moving = (args.jammer_end_x is not None
              or args.jammer_end_y is not None)
    if moving:
        end = (args.jammer_end_x if args.jammer_end_x is not None
               else args.jammer_x,
               args.jammer_end_y if args.jammer_end_y is not None
               else args.jammer_y)
        scenario.write_moving_capture_set(scn, positions, end, paths, n, fs,
                                          noise_std=args.noise,
                                          background=background)
    else:
        scenario.write_capture_set(scn, positions, paths, n, fs,
                                   noise_std=args.noise,
                                   background=background)
    print(json.dumps({"written": paths, "scenario": {
        "kind": args.kind, "jammer_m": [args.jammer_x, args.jammer_y],
        **({"jammer_end_m": list(end)} if moving else {}),
        "start_s": args.start, "duration_s": args.duration,
        "with_gps": bool(args.with_gps)}}))
    return 0


def cmd_spectrum(args) -> int:
    import os

    from .config import DEFAULT_CONFIG as CFG
    from .ops import spectral
    fs = args.sample_rate or CFG.frontend.sample_rate_hz
    n_total = os.path.getsize(args.file) // 2
    cap = (int(args.max_seconds * fs) if args.max_seconds else None)
    # 1 s chunks (widmo_plot.py:9-10), clamped for short captures;
    # streamed in bounded batches (spectrogram_file) so arbitrarily long
    # captures never load fully
    chunk = min(int(fs), cap or n_total, n_total)
    sg = spectral.spectrogram_file(args.file, fs, chunk,
                                   CFG.spectral.nperseg,
                                   max_samples=cap)
    freqs = spectral.freq_axis_mhz(fs, CFG.spectral.nperseg)
    mean_db = np.asarray(spectral.mean_spectrum_db(sg))
    if args.out:
        np.savez(args.out, spectrogram_db=sg, freq_mhz=freqs,
                 mean_db=mean_db)
    print(json.dumps({
        "chunks": int(sg.shape[0]), "nperseg": int(sg.shape[1]),
        "peak_db": float(mean_db.max()),
        "peak_freq_mhz": float(freqs[int(mean_db.argmax())]),
        "mean_noise_db": float(np.median(mean_db)),
        "out": args.out}))
    return 0


def cmd_calibrate(args) -> int:
    import jax.numpy as jnp

    from .config import DEFAULT_CONFIG as CFG
    from .models import detector
    from .ops import iq
    x = (iq.read_iq_file(args.file, convention="centered"))
    pm = detector.standalone_chunk_powers(x, CFG.detector)
    thr = float(np.asarray(detector.calibrate_threshold(pm)))
    ev = detector.standalone_events(np.asarray(pm), thr,
                                    CFG.detector.standalone_chunk_bytes // 2)
    print(json.dumps({"suggested_threshold": thr,
                      "median_power": thr / CFG.detector.calibration_factor,
                      "events_at_threshold": ev}, default=_np_default))
    return 0


def cmd_receiver(args) -> int:
    from .models.receiver import receiver as rx_mod
    from .ops import iq
    from .runtime import telemetry
    if args.streaming:
        # bounded-HBM file streaming: device holds ONE segment window
        # (segment_window_samples()) regardless of capture length
        from .runtime import rx_stream
        srx = rx_stream.StreamingReceiver(
            args.sample_rate, system=args.system,
            segment_s=args.segment_seconds, pvt_filter=args.filter)
        cap = (None if args.max_seconds is None
               else int(args.max_seconds * args.sample_rate))
        res = srx.process_file(args.file, convention="centered",
                               max_samples=cap,
                               checkpoint_path=args.checkpoint,
                               resume=args.resume,
                               wire_bits=args.wire_bits)
    else:
        x = iq.read_iq_file(args.file, convention="centered",
                            count=(int(args.max_seconds
                                       * args.sample_rate) * 2
                                   if args.max_seconds else -1))
        res = rx_mod.run_receiver(x.astype(np.complex64), args.sample_rate,
                                  system=args.system,
                                  pvt_filter=args.filter)
    fix = res.best_fix
    held = False
    if args.hold and fix is not None:
        # gnssdec -h: run every valid fix through the hold filter and
        # report the (possibly frozen) final position (sdrout.c:141-183)
        filt = telemetry.HoldPositionFilter()
        lat, lon, hgt = fix.lat_deg, fix.lon_deg, fix.height_m
        for f in res.fixes:
            if f.valid:
                lat, lon, hgt, held = filt.apply(f.lat_deg, f.lon_deg,
                                                 f.height_m)
        fix = fix._replace(lat_deg=lat, lon_deg=lon, height_m=hgt)
    out = {
        "acquired": [
            {"prn": c.prn, "doppler_hz": round(c.doppler_hz, 1),
             "peak_ratio": round(c.peak_ratio, 2),
             "cn0_dbhz": round(c.cn0_dbhz, 1)}
            for c in res.channels if c.acquired],
        "tracked_s": {str(k): round(v, 3) for k, v in
                      _tracked_seconds(res).items()},
        "decoded_prns": [c.prn for c in res.channels
                         if c.obs is not None
                         and rx_mod._eph_complete(args.system, c.obs.eph)],
        "messages": [
            {"prn": c.prn, "mt": m.mt, "tow_s": m.tow_s, "week": m.week}
            for c in res.channels for m in (c.messages or [])],
        "filter": res.filter_name,
        "n_fixes": len([f for f in res.fixes if f.valid]),
        "fix": None if fix is None else {
            "lat": fix.lat_deg, "lon": fix.lon_deg, "hgt": fix.height_m,
            "gdop": fix.gdop, "clk_bias_m": fix.clock_bias_m,
            "nsat": fix.nsat, "hold": held},
    }
    print(json.dumps(out, default=_np_default, indent=2))
    return 0


def _tracked_seconds(res) -> dict:
    """Seconds each satellite spent in a tracking slot (sat id -> s)."""
    out: dict = {}
    for sat, start, end in res.tracked_spans or []:
        out[sat] = out.get(sat, 0.0) + (end - start) * res.epoch_ms * 1e-3
    return dict(sorted(out.items()))


def cmd_serve(args) -> int:
    """Live web dashboard (the GUI layer, no Qt): idle landing page with
    the start/stop control surface, optionally auto-replaying an
    analysis of the given captures."""
    from .runtime import dashboard
    state = dashboard.DashboardState()
    ctl = dashboard.AnalysisController(state)
    srv = dashboard.make_server(state, port=args.port, controller=ctl)
    if args.files:
        # route the auto-start THROUGH the controller, so the browser's
        # stop button works on it and a second /control start is rejected
        # while it runs (a bare thread would bypass the busy() gate)
        positions = _parse_positions(args.positions, len(args.files))
        ok, msg = ctl.start({
            "files": list(args.files), "system": args.system,
            "max_seconds": args.max_seconds,
            "positions": [list(p) for p in positions],
            "realtime": args.realtime})
        if not ok:
            print(f"auto-start failed: {msg}", file=sys.stderr)
            return 2
    else:
        state.set_status("idle — start an analysis from the page "
                         "or POST /control")
    print(f"dashboard: http://127.0.0.1:{srv.server_address[1]}/ "
          "(POST telemetry to /data, start/stop via /control)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def cmd_record(args) -> int:
    """Live RTL-SDR capture (recording_dialog.py workflow, headless)."""
    from .runtime import capture
    cfg = capture.CaptureConfig(
        system=args.system, seconds=args.seconds, gain_db=args.gain,
        bias_tee=args.bias_tee, warmup_s=args.warmup)
    paths = ([args.out] if args.antennas == 1 else
             [f"{args.out}{i}.bin" for i in range(args.antennas)])
    if args.dry_run:
        cmds = [capture.build_commands(cfg, p, i)
                for i, p in enumerate(paths)]
        print(json.dumps({"tools": capture.tools_available(),
                          "commands": cmds}, indent=2))
        return 0
    if args.antennas == 1:
        res = [capture.record(cfg, paths[0])]
    else:
        res = capture.record_multi(cfg, paths)
    print(json.dumps(res, indent=2))
    return 0 if all(r.get("ok") for r in res) else 1


def cmd_report(args) -> int:
    """Full analysis + visual report: PNG plots + standalone HTML map."""
    import os

    import jax.numpy as jnp

    from .config import DEFAULT_CONFIG as CFG
    from .models import detector
    from .ops import iq, spectral
    from .runtime import pipeline
    from .utils import analysis, viz
    positions = _parse_positions(args.positions, len(args.files))
    res = pipeline.analyze_capture(
        args.files, antenna_positions=positions,
        cfg=_config_with_overrides(args),
        run_receiver=not args.no_receiver, localize=True,
        max_seconds=args.max_seconds, system=args.system,
        hold=getattr(args, "hold", False),
        sample_rate=getattr(args, "sample_rate", None),
        pvt_filter=getattr(args, "filter", "wls"),
        streaming=not getattr(args, "batch_receiver", False))
    os.makedirs(args.out, exist_ok=True)
    from .config import FrontendConfig, GnssSystem
    fs = (args.sample_rate if getattr(args, "sample_rate", None)
          else FrontendConfig.for_system(
              GnssSystem.GLONASS).sample_rate_hz
          if args.system == "glonass" else CFG.frontend.sample_rate_hz)

    raw_u8 = np.fromfile(args.files[0], dtype=np.uint8,
                         count=2 * int(fs * (args.max_seconds or 4.0)))
    viz.save_sample_histogram_png(
        raw_u8, os.path.join(args.out, "histogram.png"))

    # bounded-memory report: waterfall + power profile stream from the
    # file (same values as the in-memory kernels, tested equal)
    n_total = os.path.getsize(args.files[0]) // 2
    cap = (int(args.max_seconds * fs) if args.max_seconds else None)
    chunk = min(int(fs), cap or n_total, n_total)
    sg = spectral.spectrogram_file(args.files[0], fs, chunk,
                                   CFG.spectral.nperseg, max_samples=cap)
    viz.save_waterfall_png(sg, spectral.freq_axis_mhz(
        fs, CFG.spectral.nperseg), chunk / fs,
        os.path.join(args.out, "waterfall.png"))

    prof = np.asarray(detector.power_profile_file(
        args.files[0], CFG.detector, max_samples=cap).power_map)
    chunk_s = CFG.detector.power_chunk_samples / fs
    ev_chunks = [(s // (2 * CFG.detector.power_chunk_samples),
                  e // (2 * CFG.detector.power_chunk_samples))
                 for s, e in res.power_ranges]
    base = float(np.percentile(prof, CFG.detector.baseline_percentile))
    viz.save_power_png(prof, chunk_s,
                       base * 10 ** (CFG.detector.power_rise_db / 10.0),
                       ev_chunks, os.path.join(args.out, "power.png"))

    track = [(r["position"]["lat"], r["position"]["lon"])
             for r in res.telemetry.records if r["position"]["nsat"] > 0]
    series = analysis.per_prn_series(res.telemetry.records)
    if series:
        viz.save_prn_series_png(series,
                                os.path.join(args.out, "prn_series.png"))
    jam = None
    if res.localization and res.localization.get("success"):
        g = res.localization["location_geographic"]
        jam = (g["lat"], g["lon"])
    viz.save_map_report_html(
        os.path.join(args.out, "report.html"), track_lla=track,
        last_fix=((res.last_safe_fix["lat"], res.last_safe_fix["lon"])
                  if res.last_safe_fix else None),
        jammer_lla=jam, events=res.events,
        localization=res.localization)
    res.telemetry.save_jsonl(os.path.join(args.out, "telemetry.jsonl"))
    n_csv = analysis.export_position_csv(
        res.telemetry.records, os.path.join(args.out, "positions.csv"))
    print(json.dumps({
        "out_dir": args.out,
        "n_events": len(res.events),
        "n_csv_fixes": n_csv,
        "files": ["histogram.png", "waterfall.png", "power.png",
                  "report.html", "telemetry.jsonl", "positions.csv"]
        + (["prn_series.png"] if series else [])}))
    return 0


def cmd_analyze(args) -> int:
    """Batch accuracy table over telemetry logs (TTFF, position error,
    clock stats) — the helpers/sim.py + analyze_position.py harness."""
    from .utils import analysis
    rows = analysis.batch_report(args.logs, args.ref_lat, args.ref_lon,
                                 args.ref_hgt)
    for row, path in zip(rows, args.logs):
        row["clock"] = analysis.clock_stats(analysis.load_records(path))
    if args.out:
        flat = [{**{k: v for k, v in r.items() if k != "clock"},
                 **{f"clk_{k}": v for k, v in r["clock"].items()}}
                for r in rows]
        if args.out.endswith(".xlsx") and analysis.batch_report_excel(
                flat, args.out):
            pass
        else:
            out = args.out if args.out.endswith(".csv") else \
                args.out.rsplit(".", 1)[0] + ".csv"
            analysis.batch_report_csv(flat, out)
    print(json.dumps(rows, default=_np_default))
    return 0


def cmd_info(args) -> int:
    """Capture facts: sample count, duration, value range (the sample
    counter of app/test.py plus basic ADC sanity)."""
    import os
    rows = []
    for path in args.files:
        size = os.path.getsize(path)
        n = size // 2
        head = np.fromfile(path, dtype=np.uint8, count=min(size, 1 << 22))
        rows.append({
            "file": path, "bytes": size, "iq_samples": n,
            "duration_s": round(n / args.sample_rate, 3),
            "value_min": int(head.min()) if head.size else None,
            "value_max": int(head.max()) if head.size else None,
            "value_mean": round(float(head.mean()), 2) if head.size else None,
            "clipping_frac": round(float(np.mean((head == 0)
                                                 | (head == 255))), 6)
            if head.size else None})
    print(json.dumps(rows, indent=2))
    return 0


def cmd_benchmark(args) -> int:
    """Single-chip flagship throughput, receiver-chain throughput per
    constellation, and/or weak-scaling sweep."""
    from .runtime import benchmarks
    out = {}
    # the sweep runs first, in child processes, while this process has not
    # touched a device: a JAX process reserves most of every card's memory
    # when it starts using them, which would starve the children
    if args.scaling:
        counts = [int(v) for v in args.scaling.split(",")]
        out["weak_scaling"] = benchmarks.weak_scaling(
            counts, platform=args.platform)
    if not args.no_single:
        out["single_chip"] = benchmarks.single_chip()
    if args.receiver:
        out["receiver_chain"] = [
            benchmarks.receiver_chain(sys_, seconds=args.seconds)
            for sys_ in args.receiver.split(",")]
    print(json.dumps(out, default=_np_default, indent=2))
    return 0


def _np_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.bool_,)):
        return bool(o)
    raise TypeError(f"not JSON serializable: {type(o)}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gps_jamming_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("detect", help="full detection pipeline on captures")
    d.add_argument("files", nargs="+")
    d.add_argument("--positions", help='"x1,y1;x2,y2;..." antenna XY [m]')
    d.add_argument("--no-receiver", action="store_true")
    d.add_argument("--no-localize", action="store_true")
    d.add_argument("--max-seconds", type=float)
    d.add_argument("--telemetry-out", help="write JSONL telemetry here")
    d.add_argument("--system", default="gps",
                   choices=["gps", "glonass", "galileo"],
                   help="constellation (the reference's -g/-l/-a modes)")
    d.add_argument("--threshold-db", type=float,
                   help="F1 power-rise threshold over baseline "
                        "(settings dialog; default 6.0 dB ITU-R)")
    d.add_argument("--hold", action="store_true",
                   help="freeze reported position on >1 deg jumps "
                        "(the reference's -h flag)")
    d.add_argument("--sample-rate", type=float,
                   help="capture rate [Hz]; default = per-system "
                        "(2.048e6 GPS/Galileo, 10e6 GLONASS)")
    d.add_argument("--filter", default="wls", choices=["wls", "ekf"],
                   help="PVT filter: wls (blsFilter parity) or ekf — "
                        "the 8-state coasting EKF the reference reserves "
                        "but leaves empty (sdrpvt.c:85-88)")
    d.add_argument("--batch-receiver", action="store_true",
                   help="use the acquire-once whole-capture receiver "
                        "instead of the default self-healing streaming "
                        "receiver (short clean captures only)")
    d.add_argument("--wire-bits", type=_wire_bits, default="auto",
                   choices=["auto", 8, 4, 2, 1],
                   help="receiver upload width: 4 = two 4-bit samples "
                        "per byte (~0.14 dB C/N0 cost), 2 = four 2-bit "
                        "samples per byte (classic 4-level GNSS "
                        "quantizer, ~0.55 dB), 1 = sign bits (~1.96 dB) "
                        "— for upload-bound links; auto = 2 when the "
                        "raw byte rate exceeds 10 MB/s (GLONASS), "
                        "else 8")
    d.add_argument("--checkpoint",
                   help="persist the whole detect state here (power "
                        "profile + receiver segments + emission cursor); "
                        "resume reproduces the uninterrupted run's "
                        "events + telemetry")
    d.add_argument("--resume", action="store_true",
                   help="restore --checkpoint state and continue")
    d.add_argument("--devices", type=int,
                   help="run the SHARDED analysis over N devices on an "
                        "(antenna, time) mesh: psum-fused PSD, "
                        "all-gathered F1 profiles, sharded PCF "
                        "acquisition + pair xcorr (virtual CPU mesh via "
                        "XLA_FLAGS=--xla_force_host_platform_device_"
                        "count=N, or real GPUs)")
    d.set_defaults(fn=cmd_detect)

    loc = sub.add_parser("localize", help="RSSI + TDOA localization")
    loc.add_argument("files", nargs="+")
    loc.add_argument("--positions")
    loc.add_argument("--no-tdoa", action="store_true")
    loc.add_argument("--sample-rate", type=float,
                     help="capture rate [Hz], default 2.048e6 (TDOA lags)")
    loc.set_defaults(fn=cmd_localize)

    s = sub.add_parser(
        "simulate",
        help="generate captures: clean GPS (mode A), jammed (mode B), "
             "spoofed (mode C)")
    s.add_argument("--kind", default="chirp",
                   choices=["cw", "chirp", "broadband", "pulsed",
                            "clean", "spoof"])
    s.add_argument("--out", default="ant")
    s.add_argument("--seconds", type=float, default=1.0)
    s.add_argument("--antennas", type=int, default=3)
    s.add_argument("--positions")
    s.add_argument("--jammer-x", type=float, default=4.0)
    s.add_argument("--jammer-y", type=float, default=3.0)
    s.add_argument("--start", type=float, default=0.3)
    s.add_argument("--duration", type=float, default=0.4)
    s.add_argument("--noise", type=float, default=1.0)
    s.add_argument("--seed", type=int, default=7)
    s.add_argument("--sample-rate", type=float, default=2.048e6)
    s.add_argument("--lat", type=float, default=50.06,
                   help="receiver latitude (clean/spoof/--with-gps)")
    s.add_argument("--lon", type=float, default=19.94)
    s.add_argument("--hgt", type=float, default=219.0)
    s.add_argument("--jammer-end-x", type=float,
                   help="moving jammer: end X (linear sweep over the "
                        "capture, dynamic-mode trajectory profile)")
    s.add_argument("--jammer-end-y", type=float)
    s.add_argument("--end-lat", type=float,
                   help="mode A moving receiver: end latitude (linear "
                        "sweep, the gps-sdr-sim -u trajectory mode)")
    s.add_argument("--end-lon", type=float)
    s.add_argument("--end-hgt", type=float)
    s.add_argument("--no-weaken", action="store_true",
                   help="mode A: skip the x0.125 + AWGN weakening")
    s.add_argument("--with-gps", action="store_true",
                   help="mode B: inject the jammer over a live GPS "
                        "constellation background")
    s.add_argument("--spoof-lat", type=float, default=50.30,
                   help="mode C spoofed position")
    s.add_argument("--spoof-lon", type=float, default=20.20)
    s.add_argument("--spoof-hgt", type=float, default=15000.0)
    s.add_argument("--overpower", type=float, default=4.0,
                   help="mode C spoofer amplitude vs legit")
    s.add_argument("--ramp", type=float, default=0.5,
                   help="mode C spoofer ramp-up seconds")
    s.set_defaults(fn=cmd_simulate)

    sp = sub.add_parser("spectrum", help="Welch PSD waterfall stats")
    sp.add_argument("file")
    sp.add_argument("--out", help="write .npz here")
    sp.add_argument("--max-seconds", type=float)
    sp.add_argument("--sample-rate", type=float,
                    help="capture rate [Hz], default 2.048e6")
    sp.set_defaults(fn=cmd_spectrum)

    c = sub.add_parser("calibrate", help="standalone threshold calibration")
    c.add_argument("file")
    c.set_defaults(fn=cmd_calibrate)

    rec = sub.add_parser("record", help="live RTL-SDR capture")
    rec.add_argument("--out", default="capture.bin",
                     help="file (1 antenna) or prefix (N antennas)")
    rec.add_argument("--system", default="gps",
                     choices=["gps", "glonass", "galileo"])
    rec.add_argument("--seconds", type=float, default=60.0)
    rec.add_argument("--gain", type=float, default=40.0)
    rec.add_argument("--bias-tee", action="store_true")
    rec.add_argument("--warmup", type=float, default=0.0)
    rec.add_argument("--antennas", type=int, default=1)
    rec.add_argument("--dry-run", action="store_true",
                     help="print the rtl-sdr commands without running")
    rec.set_defaults(fn=cmd_record)

    rp = sub.add_parser("report", help="analysis + PNG/HTML visual report")
    rp.add_argument("files", nargs="+")
    rp.add_argument("--out", default="report")
    rp.add_argument("--positions")
    rp.add_argument("--no-receiver", action="store_true")
    rp.add_argument("--max-seconds", type=float)
    rp.add_argument("--system", default="gps",
                    choices=["gps", "glonass", "galileo"])
    rp.add_argument("--threshold-db", type=float,
                    help="F1 power-rise threshold over baseline [dB]")
    rp.add_argument("--hold", action="store_true",
                    help="freeze reported position on >1 deg jumps")
    rp.add_argument("--sample-rate", type=float,
                    help="capture rate [Hz]; default = per-system")
    rp.add_argument("--filter", default="wls", choices=["wls", "ekf"],
                    help="PVT filter: wls (blsFilter parity) or ekf — "
                        "the 8-state coasting EKF the reference reserves "
                        "but leaves empty (sdrpvt.c:85-88)")
    rp.set_defaults(fn=cmd_report)

    sv = sub.add_parser("serve", help="live web dashboard (GUI, no Qt)")
    sv.add_argument("files", nargs="*",
                    help="captures to analyze + replay into the dashboard")
    sv.add_argument("--port", type=int, default=1234)
    sv.add_argument("--positions",
                    help='antenna meters "x1,y1;x2,y2;..."')
    sv.add_argument("--system", default="gps",
                    choices=["gps", "glonass", "galileo"])
    sv.add_argument("--max-seconds", type=float)
    sv.add_argument("--realtime", action="store_true",
                    help="pace the replay at capture time")
    sv.set_defaults(fn=cmd_serve)

    r = sub.add_parser("receiver", help="GNSS receiver chain -> PVT fix")
    r.add_argument("file")
    r.add_argument("--sample-rate", type=float, default=2.048e6)
    r.add_argument("--max-seconds", type=float)
    r.add_argument("--system", default="gps",
                   choices=["gps", "glonass", "galileo", "sbas"],
                   help="constellation (the reference's -g/-l/-a modes; "
                        "sbas = PRN 120..138 message channel)")
    r.add_argument("--hold", action="store_true",
                   help="hold-position output filter (gnssdec -h)")
    r.add_argument("--streaming", action="store_true",
                   help="segmented receiver with channel health resets + "
                        "re-acquisition (long / jam-interrupted "
                        "captures); sbas streams message monitoring "
                        "(no PVT), like the reference's in-loop SBAS "
                        "channel")
    r.add_argument("--segment-seconds", type=float, default=4.0)
    r.add_argument("--checkpoint",
                   help="with --streaming: persist receiver state here "
                        "every ~60 s of capture (resume long runs)")
    r.add_argument("--resume", action="store_true",
                   help="restore --checkpoint state and continue; the "
                        "result equals the uninterrupted run exactly")
    r.add_argument("--wire-bits", type=_wire_bits, default="auto",
                   choices=["auto", 8, 4, 2, 1],
                   help="with --streaming: upload width (4 = packed "
                        "nibbles ~0.14 dB; 2 = 4-level quantizer "
                        "~0.55 dB; 1 = sign bits ~1.96 dB C/N0 cost; "
                        "auto = 2 for >10 MB/s raw rates, else 8)")
    r.add_argument("--filter", default="wls", choices=["wls", "ekf"],
                   help="PVT filter: wls (blsFilter parity) or ekf — "
                        "the 8-state coasting EKF the reference reserves "
                        "but leaves empty (sdrpvt.c:85-88)")
    r.set_defaults(fn=cmd_receiver)

    an = sub.add_parser(
        "analyze", help="batch accuracy report over telemetry JSONL logs")
    an.add_argument("logs", nargs="+", help="JSONL telemetry logs "
                    "(this framework's or reference capture*.txt)")
    an.add_argument("--ref-lat", type=float, required=True)
    an.add_argument("--ref-lon", type=float, required=True)
    an.add_argument("--ref-hgt", type=float)
    an.add_argument("--out", help="write table here (.xlsx or .csv)")
    an.set_defaults(fn=cmd_analyze)

    bm = sub.add_parser("benchmark",
                        help="flagship throughput + weak scaling")
    bm.add_argument("--scaling", help="comma device counts, e.g. 1,2,4,8 "
                    "(virtual CPU mesh unless --platform gpu)")
    bm.add_argument("--platform", default="cpu", choices=["cpu", "gpu"],
                    help="backend for the scaling meshes")
    bm.add_argument("--no-single", action="store_true",
                    help="skip the single-chip flagship measurement")
    bm.add_argument("--receiver",
                    help="comma list of constellations to benchmark the "
                         "full receiver chain on (gps,galileo,glonass) "
                         "at native sample rates; combine with "
                         "--no-single to skip the flagship sweep")
    bm.add_argument("--seconds", type=float, default=6.0,
                    help="receiver benchmark capture length [s]")
    bm.set_defaults(fn=cmd_benchmark)

    inf = sub.add_parser("info", help="capture file facts (sample counter)")
    inf.add_argument("files", nargs="+")
    inf.add_argument("--sample-rate", type=float, default=2.048e6)
    inf.set_defaults(fn=cmd_info)
    return p


def main(argv=None) -> int:
    from .runtime.compile_cache import enable_compile_cache
    enable_compile_cache()
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
