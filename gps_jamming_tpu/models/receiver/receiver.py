"""Full GNSS receiver chain: acquisition -> tracking -> decode -> PVT.

Orchestration equivalent of the reference's per-channel pthread state
machine + sync thread (`sdrmain.c:248-400`, `sdrsync.c:3-208`), re-designed
for batched device execution: the per-thread sequential loops collapse into
  1. ONE batched acquisition kernel over (PRN x Doppler x lag) on device,
  2. ONE `lax.scan` tracking all acquired channels simultaneously on device,
  3. host-side bit/frame decode + pseudorange formation (float64),
  4. host-side WLS PVT at the `outms` cadence (sdrinit.c:111).

The device does the sample-rate work (the 99.9% of FLOPs); the host does
the bit-rate and fix-rate work, exactly the split SURVEY.md §7 prescribes.

Multi-constellation: `system` selects GPS L1 C/A, Galileo E1B, or GLONASS
L1OF — the reference's -g/-a/-l CLI modes (sdrmain.c:37-55, with the
per-system channel plans of sdrinit.c:3-125). One system per run, like the
reference. The per-system deltas (code tables, epoch length, FDMA carrier
offsets, nav decode, satellite state) live in `systems.py` adapters; the
batched device kernels are shared.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ...config import AcquisitionConfig, TrackingConfig
from ...ops import codes as codes_ops
from ...ops import cplx
from ...utils import constants as C
from . import acquisition as acq_mod
from . import ephemeris as eph_mod
from . import galileo as gal
from . import glonass as glo
from . import observables, pvt, systems, tracking


@dataclasses.dataclass
class ChannelResult:
    prn: int                     # PRN (GPS/Galileo) or FDMA freq_ch (GLO)
    acquired: bool
    doppler_hz: float
    code_phase_samples: float
    peak_ratio: float
    cn0_dbhz: float
    obs: observables.ChannelObservables | None = None
    messages: list | None = None     # SBAS: decoded SbasMessage records


@dataclasses.dataclass
class ReceiverResult:
    channels: list[ChannelResult]
    fixes: list[pvt.PvtSolution]
    fix_epochs: list[int]        # milliseconds into the capture
    system: str = "gps"
    epoch_ms: float = 1.0
    filter_name: str = "WLS"     # telemetry FILTER| field
    # full-timeline telemetry sources (populated by both receivers):
    # mean tracked C/N0 per epoch over the channels active at that epoch
    # (the worker.py:304-318 per-record snr average, including jam windows
    # where the streaming receiver later resets the slots), and
    # (sat_id, start_epoch, end_epoch) tracking spans so TRACKED|/DECODED|
    # lists vary over time like the reference's 100 ms status.
    cn0_epochs: np.ndarray | None = None
    tracked_spans: list[tuple[int, int, int]] | None = None
    # (start_epoch, ChannelObservables) per decoded tracking interval —
    # the source for per-frame observations[] rows (epochs are local to
    # the interval; batch receiver intervals start at 0)
    obs_spans: list[tuple[int, object]] | None = None

    @property
    def best_fix(self) -> pvt.PvtSolution | None:
        valid = [f for f in self.fixes if f.valid]
        return valid[-1] if valid else None


def _system_setup(system: str, sample_rate: float,
                  acq_cfg: AcquisitionConfig):
    """Per-system acquisition inputs: (ids, replica, epoch_ms, code_len,
    chip_rate, code_period_s, code_len_chips)."""
    if system == "gps":
        n_code = int(round(sample_rate * C.GPS_CA_PERIOD_S))
        return dict(
            ids=list(range(1, 33)),
            replica=acq_mod.gps_replica_table_host(sample_rate, n_code),
            n_code=n_code, epoch_ms=1.0,
            code_len=C.GPS_CA_CODE_LEN, chip_rate=C.GPS_CA_CHIP_RATE_HZ,
            code_period_s=C.GPS_CA_PERIOD_S, code_len_chips=1023.0)
    if system == "galileo":
        n_code = int(round(sample_rate * gal.PERIOD_S))
        return dict(
            ids=list(range(1, C.GAL_NUM_PRN + 1)),
            replica=gal.replica_table_host(sample_rate, n_code),
            n_code=n_code, epoch_ms=gal.PERIOD_S * 1e3,
            code_len=gal.BOC_LEN, chip_rate=gal.BOC_RATE,
            code_period_s=gal.PERIOD_S, code_len_chips=float(gal.BOC_LEN))
    if system == "glonass":
        n_code = int(round(sample_rate * 1e-3))
        return dict(
            ids=list(glo.FREQ_CHANNELS),
            replica=None,                     # glo.acquire_all builds it
            n_code=n_code, epoch_ms=1.0,
            code_len=C.GLO_CODE_LEN, chip_rate=C.GLO_CHIP_RATE_HZ,
            code_period_s=1e-3, code_len_chips=float(C.GLO_CODE_LEN))
    if system == "sbas":
        # SBAS L1: C/A-family codes PRN 120..138, same 1 ms period as GPS
        # (sdrnav_sbs.c channel; symbols at 500 sps = 2 code periods)
        n_code = int(round(sample_rate * C.GPS_CA_PERIOD_S))
        return dict(
            ids=sorted(codes_ops._SBAS_G2_DELAY),
            replica=acq_mod.sbas_replica_table_host(sample_rate, n_code),
            n_code=n_code, epoch_ms=1.0,
            code_len=C.GPS_CA_CODE_LEN, chip_rate=C.GPS_CA_CHIP_RATE_HZ,
            code_period_s=C.GPS_CA_PERIOD_S, code_len_chips=1023.0)
    raise ValueError(f"unknown system {system!r}")


def run_receiver(x, sample_rate: float,
                 acq_cfg: AcquisitionConfig | None = None,
                 trk_cfg: TrackingConfig | None = None,
                 system: str = "gps",
                 max_channels: int = 12,
                 pvt_interval_ms: int = 200,
                 skip_epochs: int | None = None,
                 min_cn0_dbhz: float = 25.0,
                 pvt_filter: str = "wls") -> ReceiverResult:
    """Run the complete chain over a capture.

    x: complex ndarray/jax array or CArray baseband at `sample_rate`.
    system: 'gps' | 'galileo' | 'glonass' (one per run, sdrmain.c:37-55).
    pvt_filter: 'wls' (blsFilter parity) or 'ekf' — the 8-state
    pseudorange EKF (pvt.PvtEkf) seeded by the first WLS fix, with
    per-satellite innovations and outage coasting.
    Returns per-channel status + a PVT fix time series at the 200 ms
    cadence (outms, sdrinit.c:111); fix_epochs are in milliseconds.
    """
    acq_cfg = acq_cfg or AcquisitionConfig()
    trk_cfg = trk_cfg or TrackingConfig()
    xp = cplx.asarray(x)
    su = _system_setup(system, sample_rate, acq_cfg)
    n_code = su["n_code"]
    ids = su["ids"]
    if skip_epochs is None:
        # 1 s of loop pull-in regardless of epoch length
        skip_epochs = max(int(round(1000.0 / su["epoch_ms"])), 1)

    # --- 1. batched acquisition over the whole constellation -------------
    n_intg = acq_cfg.n_integration
    blocks = cplx.apply(
        lambda a: a[: n_intg * n_code].reshape(n_intg, n_code), xp)
    if system == "glonass":
        res = glo.acquire_all(blocks, sample_rate, acq_cfg)
    else:
        res = acq_mod.acquire_all(blocks, su["replica"], sample_rate,
                                  acq_cfg, code_period_s=su["code_period_s"],
                                  code_len_chips=su["code_len_chips"],
                                  method=getattr(acq_cfg, "method", "std"))
    acquired = np.asarray(res.acquired)
    ratios = np.asarray(res.peak_ratio)
    order = np.argsort(-ratios)
    sel = [int(i) for i in order if acquired[i]][:max_channels]

    channels = [ChannelResult(
        prn=ids[i], acquired=bool(acquired[i]),
        doppler_hz=float(np.asarray(res.doppler_hz)[i]),
        code_phase_samples=float(np.asarray(res.code_phase)[i]),
        peak_ratio=float(ratios[i]),
        cn0_dbhz=float(np.asarray(res.cn0_dbhz)[i]))
        for i in range(acquired.size)]
    if not sel:
        return ReceiverResult(channels, [], [], system, su["epoch_ms"])

    # --- 2. one batched tracking scan for all selected channels ----------
    if system == "gps":
        table = np.stack([codes_ops.gps_ca_code(ids[i]) for i in sel])
        carrier_v: np.ndarray | float = C.GPS_L1_FREQ_HZ
        offset_v: np.ndarray | float = 0.0
    elif system == "sbas":
        table = np.stack([codes_ops.sbas_ca_code(ids[i]) for i in sel])
        carrier_v = C.GPS_L1_FREQ_HZ
        offset_v = 0.0
    elif system == "galileo":
        table = np.stack([gal.e1b_boc_code(ids[i]) for i in sel]) \
            .astype(np.float32)
        carrier_v = C.GPS_L1_FREQ_HZ                 # E1 = L1 1575.42 MHz
        offset_v = 0.0
    else:                                            # glonass
        table = np.tile(codes_ops.glonass_code()[None, :], (len(sel), 1)) \
            .astype(np.float32)
        carrier_v = np.array([codes_ops.glonass_carrier_hz(ids[i])
                              for i in sel], np.float32)
        offset_v = np.asarray(
            glo.channel_offsets_hz(channels=[ids[i] for i in sel]),
            np.float32)

    # fine-Doppler refinement before handover: coarse 200 Hz bins can
    # false-lock the tracking loops when the epoch is long (Galileo 4 ms
    # -> +/-125 Hz FLL ambiguity); one batched sub-correlation pass
    # shrinks the error to a few Hz for every system.
    lags = np.array([channels[i].code_phase_samples for i in sel],
                    np.float32)
    dopp_rel = np.array([channels[i].doppler_hz for i in sel], np.float32)
    eff = dopp_rel + np.asarray(offset_v, np.float32)
    eff_fine = np.asarray(acq_mod.refine_doppler(
        xp, table, lags.astype(np.int32), eff, sample_rate,
        su["chip_rate"], carrier_hz=carrier_v,
        nominal_offset_hz=offset_v))
    dopp_fine = eff_fine - np.asarray(offset_v, np.float32)

    # code-phase-aligned per-channel windows: start each channel's epoch
    # grid at its acquired code boundary so data-symbol edges stay out of
    # the correlation windows (essential for E1B's symbol==epoch layout);
    # the code phase at window start is then exactly 0 chips.
    offsets = lags.astype(np.int32)
    step, run, n_epoch = tracking.make_tracker(
        table, sample_rate, trk_cfg, code_len=su["code_len"],
        chip_rate=su["chip_rate"], carrier_hz=carrier_v,
        epoch_ms=su["epoch_ms"], nominal_offset_hz=offset_v)
    st = tracking.init_state(
        len(sel), dopp_fine, np.zeros(len(sel), np.float32),
        sample_rate, code_len=su["code_len"], chip_rate=su["chip_rate"],
        carrier_hz=carrier_v, nominal_offset_hz=offset_v)
    _, outs = jax.jit(lambda s, d: run(s, d, start_offsets=offsets))(st, xp)
    ip = np.asarray(outs.i_prompt)          # (n_epochs, n_ch)
    rem = np.asarray(outs.code_rem_chips)
    cf = np.asarray(outs.carr_freq_hz)
    cn0 = np.asarray(outs.cn0_dbhz)
    n_epochs = ip.shape[0]

    # --- 3. host decode per channel --------------------------------------
    live: list[observables.ChannelObservables] = []
    for c, i in enumerate(sel):
        if np.median(cn0[-200:, c]) < min_cn0_dbhz:
            continue
        off = float(offsets[c])
        if system == "sbas":
            channels[i].messages = systems.decode_sbas_channel(
                ip[:, c], skip_epochs=skip_epochs)
            continue
        if system == "gps":
            obs = observables.build_channel_observables(
                prn=ids[i], i_prompt=ip[:, c], code_rem=rem[:, c],
                carr_freq=cf[:, c], cn0=cn0[:, c], skip_epochs=skip_epochs,
                sample_offset=off, epoch_samples=n_epoch)
        elif system == "galileo":
            obs = systems.build_galileo_observables(
                prn=ids[i], i_prompt=ip[:, c], code_rem=rem[:, c],
                carr_freq=cf[:, c], cn0=cn0[:, c], skip_epochs=skip_epochs,
                sample_offset=off, epoch_samples=n_epoch)
        else:
            obs = systems.build_glonass_observables(
                freq_ch=ids[i], i_prompt=ip[:, c], code_rem=rem[:, c],
                carr_freq=cf[:, c], cn0=cn0[:, c], skip_epochs=skip_epochs,
                sample_offset=off, epoch_samples=n_epoch)
        channels[i].obs = obs
        if obs is not None and _eph_complete(system, obs.eph):
            live.append(obs)

    # --- 4. PVT at the measurement cadence -------------------------------
    fixes: list[pvt.PvtSolution] = []
    fix_epochs: list[int] = []
    interval_ep = max(int(round(pvt_interval_ms / su["epoch_ms"])), 1)
    if len(live) >= 4:
        if system != "glonass":
            batch = eph_mod.stack_ephemeris([ch.eph for ch in live])
        x0 = None
        ekf = pvt.PvtEkf() if pvt_filter == "ekf" else None
        for m in range(skip_epochs + interval_ep, n_epochs, interval_ep):
            pr, t_tx = observables.form_pseudoranges(live, m)
            if system == "glonass":
                pos, clk = systems.glonass_sat_pos_clock(
                    [ch.eph for ch in live], t_tx)
                weeks = np.full(len(live), 2400)
            else:
                pos, clk = eph_mod.sat_pos_clock(batch, t_tx)
                # 10-bit GPS week rollover / GST WN -> full GPS week
                wk_adj = 2048 if system == "gps" else 1024
                weeks = np.array([ch.eph.week for ch in live]) + wk_adj
            snr = np.array([ch.cn0_dbhz[m] for ch in live])
            mask = pvt.precheck_mask(
                snr_dbhz=snr, week=weeks, tow_s=t_tx, pr_m=pr,
                eph_complete=[_eph_complete(system, ch.eph) for ch in live])
            if ekf is not None and ekf.initialized:
                sol = ekf.step(pos, pr, clk, mask=mask,
                               dt_s=interval_ep * su["epoch_ms"] * 1e-3)
            else:
                if mask.sum() < 4:
                    continue
                sol = pvt.solve_wls(pos, pr, clk, mask=mask, x0=x0)
                if ekf is not None and sol.valid:
                    ekf.initialize(sol)
            sol = sol._replace(
                prns=np.array([ch.prn for ch in live]))
            fixes.append(sol)
            fix_epochs.append(int(round(m * su["epoch_ms"])))
            if sol.valid:
                x0 = np.concatenate([sol.pos_ecef, [sol.clock_bias_m]])
    # telemetry sources: batch channels track the whole capture
    live_cols = [c for c, i in enumerate(sel)
                 if channels[i].obs is not None]
    cn0_epochs = (cn0[:, live_cols].mean(axis=-1) if live_cols
                  else cn0.mean(axis=-1) if cn0.size else None)
    spans = [(ids[i], 0, n_epochs) for i in sel]
    obs_spans = [(0, channels[i].obs) for i in sel
                 if channels[i].obs is not None]
    return ReceiverResult(channels, fixes, fix_epochs, system,
                          su["epoch_ms"],
                          "EKF" if pvt_filter == "ekf" else "WLS",
                          cn0_epochs=cn0_epochs, tracked_spans=spans,
                          obs_spans=obs_spans)


def _eph_complete(system: str, eph) -> bool:
    if system == "galileo":
        return gal.inav_complete(eph)
    if system == "glonass":
        return eph.complete
    return eph.complete
