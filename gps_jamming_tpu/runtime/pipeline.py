"""End-to-end analysis pipeline: the GPSAnalysisThread equivalent.

Re-design of `app/worker.py` (P3): the reference splits the job across a
C subprocess + HTTP loopback + Qt thread; here it is one in-process
pipeline over device kernels and host decode:

  1. full-capture power pre-scan -> F1 ranges     (worker.py:198-275)
  2. GNSS receiver chain -> per-100 ms telemetry  (gnssdec's role)
  3. 4-flag detector scan -> confirmed events     (worker.py:363-458)
  4. on events: RSSI triangulation + TDOA         (worker.py:567-611)
  5. telemetry records, sdrout.c JSON schema      (worker.py:277-361)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_CONFIG, FrameworkConfig
from ..models import detector, rssi, tdoa
from ..models.receiver import receiver as rx_mod
from ..ops import iq as iq_ops
from ..utils import constants as C
from . import telemetry

TELEMETRY_MS = 100             # status cadence (sdrmain.c:210)


@dataclasses.dataclass
class AnalysisResult:
    power_ranges: list[tuple[int, int]]
    events: list[dict]
    flags_trace: dict
    receiver: "rx_mod.ReceiverResult | None"
    telemetry: telemetry.TelemetryLog
    localization: dict | None
    tdoa_result: dict | None
    last_safe_fix: dict | None
    elapsed_s: float


def build_telemetry_frames(res: rx_mod.ReceiverResult, n_epochs: int,
                           n_epoch_samples: int,
                           cfg: FrameworkConfig) -> detector.TelemetryFrames:
    """Receiver outputs -> per-100 ms TelemetryFrames for the detector.

    Mirrors process_incoming_data (worker.py:277-361): C/N0 averaged over
    tracked sats, residual median/bad-count and height from the most
    recent fix, buffcnt = byte offset of the frame in the capture.
    """
    n_frames = n_epochs // TELEMETRY_MS
    t = (np.arange(n_frames, dtype=np.float64) + 1) * TELEMETRY_MS * 1e-3
    buffcnt = ((np.arange(n_frames, dtype=np.int64) + 1)
               * TELEMETRY_MS * n_epoch_samples * 2)
    cn0 = np.zeros(n_frames)
    res_med = np.zeros(n_frames)
    bad = np.zeros(n_frames)
    hgt = np.zeros(n_frames)
    nsat = np.zeros(n_frames)

    epoch_ms = res.epoch_ms if res is not None else 1.0
    cn0_series = res.cn0_epochs if res is not None else None
    live = ([c.obs for c in res.channels if c.obs is not None]
            if res is not None and cn0_series is None else [])
    for f in range(n_frames):
        m = min((f + 1) * TELEMETRY_MS, n_epochs - 1)
        e = int(m / epoch_ms)
        if cn0_series is not None and cn0_series.size:
            # full-timeline mean tracked C/N0 (includes streaming slots
            # later reset — the F2 evidence the trimmed decode intervals
            # would hide)
            cn0[f] = float(cn0_series[min(e, cn0_series.size - 1)])
        elif live:
            vals = [ch.cn0_dbhz[min(e, ch.cn0_dbhz.size - 1)]
                    for ch in live]
            cn0[f] = float(np.mean(vals))
    if res is not None and res.fixes:
        fix_ep = np.asarray(res.fix_epochs)
        for f in range(n_frames):
            m = (f + 1) * TELEMETRY_MS
            k = int(np.searchsorted(fix_ep, m, side="right")) - 1
            if k < 0 or m - fix_ep[k] > 300:
                continue
            sol = res.fixes[k]
            r = np.abs(sol.residuals_m[np.asarray(sol.residuals_m) != 0.0])
            res_med[f] = float(np.median(r)) if r.size else 0.0
            bad[f] = int(np.sum(r > cfg.detector.residual_single_sat_m))
            hgt[f] = sol.height_m if sol.valid else 0.0
            nsat[f] = sol.nsat if sol.valid else 0
    # host numpy: run_detector moves these on-device under its x64 scope,
    # keeping byte offsets exact int64 for >2 GB captures
    return detector.TelemetryFrames(
        time_s=t,
        buffcnt=buffcnt,
        cn0_avg=cn0.astype(np.float32),
        residual_median=res_med.astype(np.float32),
        residual_bad_count=bad.astype(np.float32),
        hgt=hgt.astype(np.float32),
        nsat=nsat.astype(np.float32))


def _week_adjust(system: str) -> int:
    """10-bit GPS week rollover / GST WN offset -> full GPS week (the same
    adjustment the PVT path applies before the precheck week gate)."""
    return {"gps": 2048, "galileo": 1024}.get(system, 0)


def frame_observations(res: "rx_mod.ReceiverResult", frame_ms: int,
                       fix) -> list[dict]:
    """Per-satellite observation rows for one telemetry frame.

    The reference emits observations[{prn,tow,week,snr,doppler,az,el,
    residual,innovation}] in every 100 ms record (sdrout.c:213-325, built
    from the obs_v matrix sdrsync.c:97-124); the per-PRN analysis harness
    (analiza_wielo.py / wyniki/doppler.py — P24) consumes exactly these
    rows. Here: snr/doppler/tow come from the channel's decoded epoch
    series, az/el/residual/innovation from the frame's current PVT
    solution (mapped back by PvtSolution.prns).
    """
    rows: list[dict] = []
    if res is None:
        return rows
    fix_prns = (list(np.asarray(fix.prns)) if fix is not None
                and fix.prns is not None else [])
    wk_adj = _week_adjust(res.system)
    epoch_g = int(frame_ms / res.epoch_ms)
    # decoded intervals: (start_epoch, obs) spans — time-varying for the
    # streaming receiver (a reset + re-acquired satellite contributes a
    # second span); fall back to whole-capture channel obs otherwise
    spans = res.obs_spans
    if spans is None:
        spans = [(0, c.obs) for c in res.channels if c.obs is not None]
    seen: dict[int, tuple] = {}
    for st0, obs in spans:
        local = epoch_g - st0
        if obs is None or obs.cn0_dbhz.size == 0:
            continue
        size = min(obs.cn0_dbhz.size, obs.chips.size)
        if local < 0:
            continue           # the satellite has not been tracked yet —
            # a clipped row here would report data from the future
        covers = local < size
        if not covers:
            # hold the last snapshot after the span ends, but only for
            # the reference's obs-staleness bound (checkObsDelay resets
            # channels whose obs go stale >90 s, sdrmain.c:464-511)
            stale_epochs = int(90_000.0 / res.epoch_ms)
            if obs.prn in seen or local - size > stale_epochs:
                continue
            local = size - 1
        elif obs.prn in seen and not seen[obs.prn][0]:
            pass                               # covering span wins
        elif obs.prn in seen:
            continue
        seen[obs.prn] = (covers, obs, local)
    for prn, (covers, obs, local) in sorted(seen.items()):
        az = el = resid = innov = 0.0
        if prn in fix_prns:
            k = fix_prns.index(prn)
            az = float(fix.azimuth_deg[k])
            el = float(fix.elevation_deg[k])
            resid = float(fix.residuals_m[k])
            if fix.innovations_m is not None:
                innov = float(fix.innovations_m[k])
        week = int(getattr(obs.eph, "week", 0) or 0)
        rows.append(telemetry.make_observation(
            prn=prn, tow=float(obs.transmit_time(local)),
            week=week + wk_adj if week else 0,
            snr=float(obs.cn0_dbhz[local]),
            doppler=float(obs.doppler_hz[min(local,
                                             obs.doppler_hz.size - 1)]),
            az=az, el=el, residual=resid, innovation=innov))
    return rows


def _detector_trace_bucketed(frames, ranges_pad, n_ranges, det_cfg,
                             bucket: int = 256):
    """Detector flag trace for a PARTIAL frame stream, padded to a bucket
    size so the live-emission path compiles run_detector once per bucket
    instead of once per emission length. The scan is causal (one forward
    lax.scan over frames), so the first n outputs are independent of the
    padding; events from the padded tail are discarded (the live path
    only needs the per-frame flags)."""
    n = int(np.asarray(frames.time_s).size)
    b = max(-(-n // bucket) * bucket, bucket)
    if b == n:
        _, trace = detector.run_detector(frames, ranges_pad, n_ranges,
                                         det_cfg)
        return trace

    def pad(a, fill=None):
        a = np.asarray(a)
        out = np.concatenate([a, np.full(b - n, a[-1] if fill is None
                                         else fill, a.dtype)])
        return out

    t = np.asarray(frames.time_s)
    padded = detector.TelemetryFrames(
        time_s=np.concatenate([t, t[-1] + 0.1 * np.arange(1, b - n + 1)])
        if n else np.arange(b) * 0.1,
        buffcnt=pad(frames.buffcnt),
        cn0_avg=pad(frames.cn0_avg),
        residual_median=pad(frames.residual_median),
        residual_bad_count=pad(frames.residual_bad_count),
        hgt=pad(frames.hgt), nsat=pad(frames.nsat))
    _, trace = detector.run_detector(padded, ranges_pad, n_ranges, det_cfg)
    import jax as _jax
    return _jax.tree_util.tree_map(lambda a: np.asarray(a)[:n], trace)


def iter_records(res: "rx_mod.ReceiverResult", frames, hold: bool,
                 hold_filt: "telemetry.HoldPositionFilter",
                 start_frame: int = 0):
    """Yield (frame_idx, record, fix) telemetry records for
    frames[start_frame:] — the sdrout.c:83-334 100 ms status builder.

    Shared by the post-hoc path (all frames at once) and the LIVE path
    (called with a growing partial ReceiverResult every few segments;
    pass the same HoldPositionFilter instance so the hold state carries
    across emissions).
    """
    fix_ep = np.asarray(res.fix_epochs) if res.fix_epochs else None
    acq_prns = [c.prn for c in res.channels if c.acquired]
    trk = [c.prn for c in res.channels if c.obs is not None]
    dec = [c.prn for c in res.channels
           if c.obs is not None
           and rx_mod._eph_complete(res.system, c.obs.eph)]

    def frame_lists(epoch_g: int):
        """TRACKED|/DECODED| vary with time when the receiver reports
        tracking spans (the streaming receiver's slot assignments):
        a jam-reset satellite leaves the lists and re-enters after
        re-acquisition, like the reference's 100 ms status lines."""
        if res.tracked_spans is None:
            return trk, dec
        t = sorted({s for s, a, b in res.tracked_spans
                    if a <= epoch_g < b})
        d = []
        if res.obs_spans is not None:
            d = sorted({o.prn for st0, o in res.obs_spans
                        if st0 <= epoch_g < st0 + o.cn0_dbhz.size
                        and rx_mod._eph_complete(res.system, o.eph)})
        return t, d

    from ..models.receiver import observables as _obs_mod
    anchor = None          # (week, tow_offset): TIME = elapsed + offset
    for f in range(start_frame, len(np.asarray(frames.time_s))):
        m = (f + 1) * TELEMETRY_MS
        fix = None
        if fix_ep is not None:
            k = int(np.searchsorted(fix_ep, m, side="right")) - 1
            # a fix is "current" only within one PVT cadence + one
            # frame; stale fixes must not masquerade as live telemetry
            if (k >= 0 and res.fixes[k].valid
                    and m - fix_ep[k] <= 300):
                fix = res.fixes[k]
        is_hold = False
        if fix is not None:
            h_lat, h_lon, h_hgt, is_hold = hold_filt.apply(
                fix.lat_deg, fix.lon_deg, fix.height_m)
            if hold and is_hold:
                fix = fix._replace(lat_deg=h_lat, lon_deg=h_lon,
                                   height_m=h_hgt)
        trk_f, dec_f = frame_lists(int(m / res.epoch_ms))
        obs_rows = frame_observations(res, m, fix)
        # TIME| = real GPS time once any channel has decoded (the
        # reference renders the 1980 epoch before the first decode and
        # the UTC of the common ToW after, sdrout.c:205-212). The
        # receive-time anchor is set ONCE from the first decoded frame
        # (min transmit ToW + the PTIMING nominal transit, the same
        # t_rx convention the PVT uses) and then advances with elapsed
        # time — continuous, not jumping with whichever satellite
        # happens to head the observation list.
        week, tow = 0, float(frames.time_s[f])
        if anchor is None:
            wk_rows = [o for o in obs_rows if o["week"]]
            if wk_rows:
                t_rx = (min(o["tow"] for o in wk_rows)
                        + _obs_mod.PTIMING_S)
                anchor = (wk_rows[0]["week"],
                          t_rx - float(frames.time_s[f]))
        if anchor is not None:
            week = anchor[0]
            tow = float(frames.time_s[f]) + anchor[1]
        rec = telemetry.make_record(
            elapsed_s=float(frames.time_s[f]),
            time_s=tow if week else float(frames.time_s[f]),
            buffcnt=int(frames.buffcnt[f]),
            acq_prns=acq_prns, tracked_prns=trk_f,
            decoded_prns=dec_f,
            fix=fix, hold=is_hold, filter_name=res.filter_name,
            observations=obs_rows, week=week)
        yield f, rec, fix


def analyze_capture(paths: Sequence[str],
                    antenna_positions: Sequence[tuple[float, float]]
                    | None = None,
                    cfg: FrameworkConfig = DEFAULT_CONFIG,
                    run_receiver: bool = True,
                    localize: bool = True,
                    max_seconds: float | None = None,
                    system: str = "gps",
                    hold: bool = False,
                    sample_rate: float | None = None,
                    pvt_filter: str = "wls",
                    streaming: bool = True,
                    segment_s: float = 4.0,
                    sink=None,
                    emit_every_s: float = 8.0,
                    wire_bits: int | str = "auto",
                    checkpoint_path: str | None = None,
                    checkpoint_every_s: float = 60.0,
                    resume: bool = False) -> AnalysisResult:
    """Analyze 1-3 antenna captures end to end (start_analysis flow,
    ui_mainwindow.py:653 -> worker.py:477-547).

    system: constellation for the receiver chain — the GUI's GPS /
    GLONASS / Galileo selector (ui_mainwindow.py:60-77; note the
    reference's GUI->CLI flag mapping is inconsistent, worker.py:104-111
    vs sdrmain.c:37-55 — here the name is the contract).
    hold: freeze the REPORTED position while the fix is held (the
    reference's -h hold-position filter, sdrout.c:141-183); when False
    the telemetry still carries the hold flag but reports the raw fix.
    sample_rate: capture sample rate override; default = the per-system
    front-end rate (2.048 MS/s GPS/Galileo, 10 MS/s GLONASS — the GUI's
    per-system params, ui_mainwindow.py:60-77 / sdrinit.c:3-13).
    pvt_filter: 'wls' (blsFilter parity) or 'ekf' (the 8-state coasting
    EKF the reference reserves but never implements, sdrpvt.c:85-88);
    the telemetry FILTER field and observations[].innovation follow it.
    streaming (default): the PRODUCT path — bounded-HBM file-streamed
    power pre-scan plus the self-healing segmented receiver
    (rx_stream.StreamingReceiver.process_file: channel health resets,
    re-acquisition after jamming, ephemeris reuse — the operating mode of
    gnssdec's channel threads, sdrmain.c:248-400 + :417-511). Device
    memory stays one segment window regardless of capture length.
    streaming=False runs the acquire-once whole-capture batch receiver
    (short clean captures; results match on those).
    sink: optional callable(record) — LIVE telemetry: on the streaming
    path, records are built and pushed every ~emit_every_s of capture
    WHILE segments are still processing (gnssdec POSTs each 100 ms
    record as produced, sdrout.c:10-57; the serve dashboard shows
    position/flags advancing mid-analysis). The returned AnalysisResult
    still carries the authoritative full record log.
    wire_bits: "auto" (default), 8, 4, 2 or 1 — upload width of the
    streamed receiver windows; auto resolves to 2-bit packing for raw
    rates above 10 MB/s (GLONASS) and lossless 8-bit otherwise
    (see StreamingReceiver.process_file).
    checkpoint_path (streaming only): persist the WHOLE product path —
    power-scan profile + F1 ranges, the receiver's segment state
    (chained at <path>.rx), and the live-emission cursor — so a killed
    `detect` resumes mid-capture and produces the SAME final events +
    telemetry as the uninterrupted run (events/telemetry are a pure
    function of receiver result + power profile, both checkpointed).
    Live sink emission on resume is at-least-once: the cursor is saved
    at emission time, so a handful of records straddling the kill may be
    re-pushed.
    """
    import os
    import pickle
    import tempfile

    t_start = time.time()
    ck_state: dict | None = None
    if checkpoint_path is not None and streaming:
        if resume and os.path.exists(checkpoint_path):
            with open(checkpoint_path, "rb") as f:
                ck_state = pickle.load(f)
        if ck_state is None:
            ck_state = {"profile": None, "ranges": None, "emitted": 0,
                        "meta": {"paths": list(paths), "system": system,
                                 "max_seconds": max_seconds}}
        elif ck_state["meta"] != {"paths": list(paths), "system": system,
                                  "max_seconds": max_seconds}:
            raise ValueError(
                f"detect checkpoint was written for "
                f"{ck_state['meta']}, not this invocation")

    def save_detect_ckpt():
        d = os.path.dirname(os.path.abspath(checkpoint_path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(ck_state, f)
            os.replace(tmp, checkpoint_path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
    if sample_rate is not None:
        fs = float(sample_rate)
    elif system == "glonass":
        from ..config import FrontendConfig, GnssSystem
        fs = FrontendConfig.for_system(GnssSystem.GLONASS).sample_rate_hz
    else:
        fs = cfg.frontend.sample_rate_hz
    n_epoch = int(round(fs * 1e-3))

    n_samples = os.path.getsize(paths[0]) // 2
    if max_seconds is not None:
        n_samples = min(n_samples, int(max_seconds * fs))

    # 1. power pre-scan (F1 map)
    if ck_state is not None and ck_state["profile"] is not None:
        prof = ck_state["profile"]         # resume: skip the file re-scan
        ranges = ck_state["ranges"]
    else:
        if streaming:
            prof = detector.power_profile_file(paths[0], cfg.detector,
                                               max_samples=n_samples)
        else:
            raw = np.fromfile(paths[0], dtype=np.uint8,
                              count=2 * n_samples)
            x = iq_ops.int8_to_planar(
                jnp.asarray(iq_ops.uint8_np_to_int8(raw)))
            prof = detector.power_profile(x, cfg.detector)
        ranges = detector.power_profile_ranges(prof, cfg.detector)
        if ck_state is not None:
            import jax as _jax
            ck_state["profile"] = _jax.tree_util.tree_map(np.asarray, prof)
            ck_state["ranges"] = ranges
            save_detect_ckpt()
    ranges_pad, n_ranges = detector.ranges_to_padded(ranges)

    # 2. receiver chain
    res = None
    if run_receiver:
        if streaming:
            from . import rx_stream
            srx = rx_stream.StreamingReceiver(
                fs, system=system, segment_s=segment_s,
                pvt_filter=pvt_filter)
            cap = (None if max_seconds is None
                   else int(max_seconds * fs))
            segment_cb = None
            if sink is not None:
                live_hold = telemetry.HoldPositionFilter()
                emitted = [ck_state["emitted"] if ck_state else 0]
                emit_frames = max(int(emit_every_s * 1000 / TELEMETRY_MS),
                                  1)

                def segment_cb(done, n_total, snapshot):
                    ms_cov = int(done * srx.seg_epochs * srx.su["epoch_ms"])
                    n_frames = ms_cov // TELEMETRY_MS
                    if n_frames == 0 or (n_frames - emitted[0] < emit_frames
                                         and done < n_total):
                        return
                    part = snapshot()          # decode + PVT on data so far
                    pf = build_telemetry_frames(part, ms_cov, n_epoch, cfg)
                    ptrace = _detector_trace_bucketed(
                        pf, ranges_pad, n_ranges, cfg.detector)
                    pjam = np.asarray(ptrace.is_jamming)
                    # hold back the boundary frame mid-run: its epoch sits
                    # exactly at the covered-span edge, so its TRACKED/
                    # DECODED lists would be empty here but populated in
                    # the authoritative post-hoc log — emit it next cycle
                    stop = n_frames - 1 if done < n_total else n_frames
                    for f, rec, fix in iter_records(
                            part, pf, hold, live_hold,
                            start_frame=emitted[0]):
                        if f >= stop:
                            break
                        rec["jamming"] = bool(pjam[f]) \
                            if f < pjam.size else False
                        sink(rec)
                    emitted[0] = stop
                    if ck_state is not None:
                        ck_state["emitted"] = stop
                        save_detect_ckpt()

            res = srx.process_file(paths[0], convention="centered",
                                   max_samples=cap,
                                   segment_cb=segment_cb,
                                   wire_bits=wire_bits,
                                   checkpoint_path=(
                                       checkpoint_path + ".rx"
                                       if ck_state is not None else None),
                                   checkpoint_every_s=checkpoint_every_s,
                                   resume=resume)
        else:
            res = rx_mod.run_receiver(x, fs, system=system,
                                      pvt_filter=pvt_filter)
    n_epochs = n_samples // n_epoch

    # 3. telemetry + detector
    frames = build_telemetry_frames(res, n_epochs, n_epoch, cfg)
    final, trace = detector.run_detector(frames, ranges_pad, n_ranges,
                                         cfg.detector)
    events = detector.events_to_list(final)

    # telemetry records + last safe fix (worker.py:339-346)
    log = telemetry.TelemetryLog()
    hold_filt = telemetry.HoldPositionFilter()
    last_safe = None
    jam_trace = np.asarray(trace.is_jamming)
    if res is not None:
        for f, rec, fix in iter_records(res, frames, hold, hold_filt):
            log.append(rec)
            if fix is not None and f < jam_trace.size and not jam_trace[f]:
                last_safe = {"lat": fix.lat_deg, "lon": fix.lon_deg,
                             "hgt": fix.height_m,
                             "time": float(frames.time_s[f])}

    # 4. localization on detected jamming
    loc = None
    td = None
    if localize and events and antenna_positions is not None \
            and len(paths) >= 2:
        if streaming:
            # bounded host memory: streamed ranging + onset scans (the
            # in-memory path loads every antenna capture in full)
            loc = rssi.triangulate_files(paths, antenna_positions,
                                         cfg=cfg.rssi)
            try:
                td = tdoa.localize_files(paths, antenna_positions, fs,
                                         cfg=cfg.tdoa)
            except ValueError:         # no onset above the TDOA threshold
                td = None
        else:
            caps = [(iq_ops.read_iq_file(p, convention="normalized"))
                    for p in paths]
            loc = rssi.triangulate(caps, antenna_positions, cfg=cfg.rssi)
            caps_c = [(iq_ops.read_iq_file(p, convention="centered"))
                      for p in paths]
            try:
                td = tdoa.localize(caps_c, antenna_positions, fs,
                                   cfg=cfg.tdoa)
            except ValueError:         # no onset above the TDOA threshold
                td = None

    return AnalysisResult(
        power_ranges=ranges, events=events,
        flags_trace={
            "f1": np.asarray(trace.f1), "f2": np.asarray(trace.f2),
            "f3": np.asarray(trace.f3), "f4": np.asarray(trace.f4),
            "jamming": jam_trace,
        },
        receiver=res, telemetry=log, localization=loc, tdoa_result=td,
        last_safe_fix=last_safe, elapsed_s=time.time() - t_start)
