"""Streaming receiver: segmented tracking with health resets + re-acquisition.

The reference receiver is self-healing: channels reset themselves when
SNR drops below 15 dB-Hz, nav fails to decode, or observations go stale
(sdrmain.c:263-340 health checks, resetStructs :417-462, checkObsDelay
:464-511), and freed channels re-run acquisition. The batch
run_receiver acquires once and tracks to EOF — fine for short captures,
wrong for long ones where jamming kills lock mid-capture.

This driver processes the capture in fixed-length segments over a pool
of channel SLOTS:
  - per segment, one tracking scan advances every slot (one compiled
    executable for all segments: the code table / carrier / FDMA offset /
    window offsets / per-slot ages are traced arguments),
  - slots failing any of the four reference health checks are freed:
    low C/N0, nav-not-decoded after 60 s / stale week / low elevation
    (sdrmain.c:263-340), and stale observables > 90 s (checkObsDelay,
    sdrmain.c:464-511),
  - free slots are filled by re-running batched acquisition on the
    segment head for constellation IDs not currently tracked,
  - per-slot output streams are split at assignment boundaries, decoded
    with the per-system adapters, and PVT runs over whichever channels
    cover each measurement epoch.

Tracking loop staging (FLL pull-in -> PLL locked) is per-slot: a slot
(re)acquired mid-capture starts its own pull-in, exactly like a
reference channel thread after resetStructs.

Pipelining (the datathread/channel-thread overlap of sdrmain.c:402-415,
re-expressed): window assembly + host->device upload for segment k+1 run
in an IO worker thread while segment k's scan executes on device, and
interval decoding (bit sync -> nav frames) runs in a decode worker that
doubles as the nav-health prober — the serial end-of-run decode the
batch path pays is warmed incrementally instead.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

from ..config import AcquisitionConfig, TrackingConfig
from ..models.receiver import acquisition as acq_mod
from ..models.receiver import ephemeris as eph_mod
from ..models.receiver import galileo as gal
from ..models.receiver import glonass as glo
from ..models.receiver import observables, pvt, systems, tracking
from ..models.receiver.receiver import (ChannelResult, ReceiverResult,
                                        _eph_complete, _system_setup)
from ..ops import codes as codes_ops
from ..ops import cplx


@dataclasses.dataclass
class SlotInterval:
    """One contiguous assignment of a constellation ID to a slot."""
    sat_id: int                 # PRN (GPS/GAL) or FDMA freq_ch (GLO)
    slot: int
    start_epoch: int            # global epoch of first tracked epoch
    n_epochs: int = 0
    sample_offset: float = 0.0  # absolute window start of start_epoch
    i_prompt: np.ndarray | None = None
    code_rem: np.ndarray | None = None
    carr_freq: np.ndarray | None = None
    cn0: np.ndarray | None = None
    obs: observables.ChannelObservables | None = None


def _system_tables(system: str, sel_ids):
    if system == "gps":
        tab = np.stack([codes_ops.gps_ca_code(i) for i in sel_ids])
        return tab.astype(np.float32), None, None
    if system == "sbas":
        tab = np.stack([codes_ops.sbas_ca_code(i) for i in sel_ids])
        return tab.astype(np.float32), None, None
    if system == "galileo":
        tab = np.stack([gal.e1b_boc_code(i) for i in sel_ids])
        return tab.astype(np.float32), None, None
    tab = np.tile(codes_ops.glonass_code()[None, :], (len(sel_ids), 1))
    carr = np.array([codes_ops.glonass_carrier_hz(i) for i in sel_ids],
                    np.float32)
    offs = np.asarray(glo.channel_offsets_hz(channels=list(sel_ids)),
                      np.float32)
    return tab.astype(np.float32), carr, offs


# Reference channel plans: 32 GPS / 36 Galileo / 14 GLONASS concurrent
# channels (sdrinit.c:41-107); SBAS = the 19 C/A PRNs 120..138. The
# batched scan's per-epoch work is one (slots, taps, n) einsum, so the
# full plans cost near-nothing over a reduced pool (slot-scaling row in
# BASELINE.md) — unlike the reference's thread-per-channel model.
CHANNEL_PLAN = {"gps": 32, "galileo": 36, "glonass": 14, "sbas": 19}


class StreamingReceiver:
    def __init__(self, sample_rate: float, system: str = "gps",
                 n_slots: int | None = None, segment_s: float = 4.0,
                 acq_cfg: AcquisitionConfig | None = None,
                 trk_cfg: TrackingConfig | None = None,
                 reset_cn0_dbhz: float = 15.0,
                 min_cn0_dbhz: float = 25.0,
                 grace_segments: int = 1,
                 pvt_filter: str = "wls",
                 acq_holdoff_s: float | None = None,
                 reset_nodecode_s: float = 60.0,
                 reset_obs_stale_s: float = 90.0,
                 reset_week_min: int = 2360,
                 reset_elevation_deg: float = 12.0,
                 health_probe_every_s: float = 16.0):
        self.fs = sample_rate
        self.system = system
        self.pvt_filter = pvt_filter
        self.acq_cfg = acq_cfg or AcquisitionConfig()
        self.trk_cfg = trk_cfg or TrackingConfig()
        self.su = _system_setup(system, sample_rate, self.acq_cfg)
        if n_slots is None:
            n_slots = min(CHANNEL_PLAN.get(system, 12),
                          len(self.su["ids"]))
        self.n_slots = n_slots
        self.reset_cn0 = reset_cn0_dbhz
        self.min_cn0 = min_cn0_dbhz
        self.grace = grace_segments
        # the three nav-level health-reset causes beyond the C/N0 check
        # (sdrmain.c:263-340 nodecode/week/elevation, :464-511 stale obs);
        # evaluated by the periodic decode probe (_probe rounds)
        self.reset_nodecode_s = reset_nodecode_s
        self.reset_obs_stale_s = reset_obs_stale_s
        self.reset_week_min = reset_week_min
        self.reset_elevation_deg = reset_elevation_deg
        seg_s_eff = segment_s
        self.probe_every = max(
            int(round(health_probe_every_s / seg_s_eff)), 1)
        # segments to skip after an acquisition attempt that assigned no
        # slot (the reference sleeps 10 s after resetStructs before the
        # channel searches again, sdrmain.c:417-462; an empty search costs
        # a dispatch + fetch round trip per segment). Default: one skipped
        # segment between failed attempts
        # — lighter than the reference's 10 s because the segmented
        # decode re-anchors per interval, so late re-acquisition directly
        # delays the first post-jam fix. An attempt that DOES assign
        # keeps searching next segment (hot signal), and a health reset
        # re-arms the search immediately.
        if acq_holdoff_s is None:
            acq_holdoff_s = 2.0 * segment_s
        self.acq_holdoff = max(int(round(acq_holdoff_s / segment_s)), 1)
        n_epoch = int(round(sample_rate * self.su["epoch_ms"] * 1e-3))
        self.seg_epochs = max(int(segment_s * 1000.0
                                  / self.su["epoch_ms"]), 1)
        dummy = np.zeros((n_slots, self.su["code_len"]), np.float32)
        _, self._run, self.n_epoch = tracking.make_tracker(
            dummy, sample_rate, self.trk_cfg, code_len=self.su["code_len"],
            chip_rate=self.su["chip_rate"],
            carrier_hz=np.zeros(n_slots, np.float32) + 1575.42e6,
            epoch_ms=self.su["epoch_ms"],
            nominal_offset_hz=np.zeros(n_slots, np.float32))
        # per-slot loop staging: epoch index seen by the FLL/PLL stage
        # switch is the slot's AGE (epochs since its own acquisition) —
        # k runs 0..seg_epochs within a segment, so start_epoch = age
        def _run_packed(st, x, offs_ages, tab, carr, offhz):  # noqa: E306
            offs, ages = offs_ages[0], offs_ages[1]
            # int8 window from process_file: convert on DEVICE — the
            # host->device transfer is 4x smaller than float32 planes
            # (320 MB/segment at GLONASS 10 MS/s x 4 s)
            x = self._ingest(x)
            st2, outs = self._run(
                st, x, start_epoch=ages, start_offsets=offs,
                table_arg=tab, carrier_arg=carr, offset_arg=offhz,
                n_epochs=self.seg_epochs)
            # pack the 4 consumed output streams into ONE array: one
            # host fetch instead of 9 per-field fetches (the state stays
            # on device)
            packed = jnp.stack([outs.i_prompt, outs.code_rem_chips,
                                outs.carr_freq_hz, outs.cn0_dbhz])
            return st2, packed
        self._run_packed_fn = _run_packed
        self._jit_run = jax.jit(_run_packed)
        # device-side caches: the code table / carrier / FDMA offsets are
        # re-uploaded only when a slot assignment changes, and the whole
        # acquisition + fine-Doppler refinement runs as ONE jitted
        # dispatch each instead of per-op dispatches.
        self._dev_tabs: tuple | None = None
        # wire format of file-streamed windows: ("i8", off, scale) = one
        # int8 byte per I/Q component (process_file default), or
        # ("i4", scale) = two 4-bit samples packed per byte — HALF the
        # host->device bytes for host-limited links at a ~0.14 dB
        # C/N0 cost (16-level quantization of a +/-2.5 sigma range; the
        # classic multi-bit GNSS quantization loss bound)
        self._ingest_conv = ("i8", 0.5, 1.0)
        self._jit_acquire = jax.jit(self._acquire_packed)
        self._jit_refine = jax.jit(self._refine_traced)
        # decoded-observables cache: (sat, start_epoch, n_epochs) -> obs.
        # Live snapshots re-run _decode_pvt every few segments; closed
        # intervals hit this cache exactly, and open intervals decode a
        # BUCKETED prefix (snapshot path) so their key only changes every
        # few segments — keeps live emission ~O(n) instead of O(n^2).
        # Shared with the decode worker thread (probe rounds + closed-
        # interval warming) under _obs_lock.
        self._obs_cache: dict = {}
        self._obs_inflight: dict = {}
        self._obs_lock = threading.Lock()
        # pipeline workers (live with the receiver): window assembly +
        # upload one segment ahead, and interval decode / nav-health
        # probing off the critical path
        self._io_pool = ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="rx-io")
        self._dec_pool = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="rx-dec")

    # -- acquisition over a segment head ---------------------------------
    def _ingest(self, x):
        """Device-side wire -> float32 conversion for file-streamed
        windows (wire mode baked at trace time; process_file re-wraps the
        jits when the convention changes). Float windows pass through.

        "i8": one int8 byte per component, x_f = (v + off) * scale.
        "i4": two 4-bit samples per byte (even sample in the low nibble),
        unpacked with arithmetic shifts and rescaled — the upload is half
        the bytes; everything downstream (dynamic_slice offsets in
        SAMPLES) is unchanged because the unpack happens first.
        """
        if not jnp.issubdtype(x.re.dtype, jnp.integer):
            return x
        # packed wires use BLOCK layout (byte j carries samples j,
        # j+W/2, ... — not adjacent pairs): the unpack is then a pure
        # concatenation of the shifted planes. An interleaving unpack
        # (stack(..., axis=-1).reshape) materializes an (N, 2|4) f32
        # intermediate whose minor dim pads to a full tile on an
        # accelerator with 128-wide lanes — a 64x blowup that ran out of
        # device memory on 8 s GLONASS windows there (not measured on
        # H100).
        if self._ingest_conv[0] == "i4":
            scale = self._ingest_conv[1]

            def unpack(b):
                lo = jnp.right_shift(jnp.left_shift(b, 4), 4)
                hi = jnp.right_shift(b, 4)
                return (jnp.concatenate([lo, hi])
                        .astype(jnp.float32) * scale)

            return cplx.CArray(unpack(x.re), unpack(x.im))
        if self._ingest_conv[0] == "i2":
            # four 2-bit fields per byte, levels (2q+1)*delta with
            # q in {-2..1} -> {-3,-1,1,3}*delta (the classic optimal
            # 2-bit GNSS quantizer, ~0.55 dB SNR cost)
            delta = self._ingest_conv[1]

            def unpack(b):
                fs_ = [jnp.right_shift(jnp.left_shift(b, 6 - 2 * k), 6)
                       for k in range(4)]
                v = jnp.concatenate(fs_)
                return (2.0 * v.astype(jnp.float32) + 1.0) * delta

            return cplx.CArray(unpack(x.re), unpack(x.im))
        if self._ingest_conv[0] == "i1":
            # eight sign bits per byte, levels (2q+1)*delta with
            # q in {-1, 0} -> +/-delta (1-bit sign quantizer, ~1.96 dB)
            delta = self._ingest_conv[1]

            def unpack(b):
                fs_ = [jnp.right_shift(jnp.left_shift(b, 7 - k), 7)
                       for k in range(8)]
                v = jnp.concatenate(fs_)
                return (2.0 * v.astype(jnp.float32) + 1.0) * delta

            return cplx.CArray(unpack(x.re), unpack(x.im))
        _, off, scale = self._ingest_conv
        return cplx.CArray((x.re.astype(jnp.float32) + off) * scale,
                           (x.im.astype(jnp.float32) + off) * scale)

    def _acquire_traced(self, xp, seg_start):
        su, cfg = self.su, self.acq_cfg
        xp = self._ingest(xp)
        n_code = su["n_code"]
        blocks = cplx.apply(
            lambda a: jax.lax.dynamic_slice(
                a, (seg_start,), (cfg.n_integration * n_code,)
            ).reshape(cfg.n_integration, n_code), xp)
        if self.system == "glonass":
            return glo.acquire_all(blocks, self.fs, cfg)
        return acq_mod.acquire_all(
            blocks, su["replica"], self.fs, cfg,
            code_period_s=su["code_period_s"],
            code_len_chips=su["code_len_chips"],
            method=getattr(cfg, "method", "std"))

    def _acquire_packed(self, xp, seg_start):
        r = self._acquire_traced(xp, seg_start)
        return jnp.stack([r.acquired.astype(jnp.float32), r.code_phase,
                          r.doppler_hz, r.peak_ratio, r.cn0_dbhz])

    def _acquire(self, xp, seg_start: int):
        """One jitted dispatch + ONE host fetch: (5, n_prn) rows =
        acquired, code_phase, doppler_hz, peak_ratio, cn0_dbhz."""
        return np.asarray(self._jit_acquire(xp, jnp.int32(seg_start)))

    def _refine_traced(self, xp, tab, lags, eff, carr, offhz):
        xp = self._ingest(xp)
        return acq_mod.refine_doppler(
            xp, tab, lags, eff, self.fs, self.su["chip_rate"],
            carrier_hz=carr, nominal_offset_hz=offhz)

    def _refine(self, xp, t2, lags, eff, c2, o2):
        """Fixed-shape (n_slots) jitted fine-Doppler refinement: pads the
        newly acquired channels up to the slot count so re-acquisition
        never triggers a fresh compile mid-stream."""
        k = t2.shape[0]
        pad = self.n_slots - k
        tab = np.zeros((self.n_slots, t2.shape[1]), np.float32)
        tab[:k] = t2
        lags_p = np.zeros(self.n_slots, np.int32)
        lags_p[:k] = lags
        eff_p = np.zeros(self.n_slots, np.float32)
        eff_p[:k] = eff
        carr_p = np.full(self.n_slots, 1575.42e6, np.float32)
        offhz_p = np.zeros(self.n_slots, np.float32)
        if c2 is not None:
            carr_p[:k] = c2
            offhz_p[:k] = o2
        del pad
        out = self._jit_refine(xp, jnp.asarray(tab), jnp.asarray(lags_p),
                               jnp.asarray(eff_p), jnp.asarray(carr_p),
                               jnp.asarray(offhz_p))
        return np.asarray(out)[:k]

    def segment_window_samples(self) -> int:
        """Device window length needed per segment: the segment's epochs
        plus one code period of lag slack plus one epoch of slew margin."""
        return (self.seg_epochs * self.n_epoch + self.su["n_code"]
                + self.n_epoch)

    def process(self, x, verbose: bool = False,
                segment_cb=None) -> ReceiverResult:
        """One-shot path: the whole capture device-resident (short files).

        segment_cb(seg_done, n_seg, snapshot): called after every segment;
        snapshot() decodes the data-so-far into a partial ReceiverResult
        (live telemetry hook — see _decode_pvt)."""
        xp = cplx.asarray(x)
        n = xp.shape[-1]
        n_seg = (n - self.su["n_code"]) // (self.seg_epochs * self.n_epoch)

        def get_window(seg):
            return 0, xp                       # base offset, full capture

        return self._process_core(get_window, n_seg, verbose,
                                  segment_cb=segment_cb)

    def process_file(self, path: str, verbose: bool = False,
                     convention: str = "centered",
                     max_segments: int | None = None,
                     max_samples: int | None = None,
                     segment_cb=None,
                     checkpoint_path: str | None = None,
                     checkpoint_every_s: float = 60.0,
                     resume: bool = False,
                     wire_bits: int = 8) -> ReceiverResult:
        """Streaming path: bounded HBM for arbitrarily long captures.

        Feeds the receiver from `native.reader.CaptureReader` (the C++
        double-buffered prefetch reader — sdrrcv.c:61-107 ring-buffer role)
        one segment window at a time: device memory holds ONE window of
        `segment_window_samples()` samples (~2*4B*seg_len), independent of
        file length, and host memory holds two reader blocks. A 1-hour
        10 MS/s GLONASS capture streams in ~320 MB windows instead of a
        ~290 GB resident array.

        convention: 'centered' (x-127.5, default receiver contract),
        'int8' (x-128) or 'normalized' ((x-127.5)/127.5).

        checkpoint_path: periodically persist the full receiver state
        (slot assignments, device tracking state, intervals, spans,
        C/N0 accumulators) at segment boundaries; resume=True restores
        it and continues from the saved segment, producing EXACTLY the
        uninterrupted run's result (the checkpoint/resume role SURVEY §5
        assigns to long captures; the reference has none — rerun is its
        only recovery). The reader re-skips the file prefix on resume
        (sequential IO only).

        wire_bits: 8 (default) uploads int8 component planes; 4 packs
        two 4-bit samples per byte before upload — half the host->device
        bytes, for links where the upload is the wall-clock bottleneck.
        Quantization maps +/-2.5
        sigma of the first block onto the 16 levels (~0.14 dB C/N0
        cost); 2 is the classic 4-level GNSS quantizer (~0.55 dB) at a
        quarter of the bytes; 1 is the sign quantizer (~1.96 dB) at an
        eighth — jamming-monitor links where transfer, not sensitivity,
        is the constraint. "auto" picks 2 when the capture's raw byte
        rate exceeds 10 MB/s (GLONASS at 10 MS/s) and 8 otherwise
        (GPS/Galileo); the rule dates from a 30 MB/s host link and is not
        measured on H100 over PCIe. The quantize+pack runs as one fused
        GIL-free C++ pass on the IO worker when the native reader is
        built (native/capture_reader.cpp rdr_quantpack; numpy
        fallback otherwise). The power pre-scan / localization paths
        read the file directly and are unaffected.
        """
        import pickle

        from ..native.reader import CaptureReader

        ckpt = None
        if checkpoint_path is not None:
            seg_s = self.seg_epochs * self.su["epoch_ms"] * 1e-3
            state = None
            if resume and os.path.exists(checkpoint_path):
                with open(checkpoint_path, "rb") as f:
                    state = pickle.load(f)
            ckpt = {"path": checkpoint_path,
                    "every": max(int(round(checkpoint_every_s / seg_s)), 1),
                    "state": state}

        S = self.seg_epochs * self.n_epoch
        W = self.segment_window_samples()
        n_bytes = os.path.getsize(path)
        n = n_bytes // 2
        if max_samples is not None:
            # a cap truncates exactly like EOF: whole segments only
            n = min(n, int(max_samples))
        n_seg = (n - self.su["n_code"]) // S
        if max_segments is not None:
            n_seg = min(n_seg, max_segments)
        if convention == "centered":
            off, scale = 0.5, 1.0
        elif convention == "int8":
            off, scale = 0.0, 1.0
        elif convention == "normalized":
            off, scale = 0.5, 1.0 / 127.5
        else:
            raise ValueError(f"unknown convention {convention!r}")
        if wire_bits == "auto":
            # earlier-accelerator rule for a ~30 MB/s host link, where
            # only GLONASS's 20 MB/s raw rate was transfer-bound; not
            # measured on H100 over PCIe
            wire_bits = 2 if 2.0 * self.fs > 10e6 else 8
        pack_lut = None
        if wire_bits in (4, 2, 1):
            head_u8 = np.fromfile(path, dtype=np.uint8,
                                  count=min(2 * S, n_bytes))
            sigma = float(np.std(head_u8.astype(np.float32) - 127.5))
            vals = np.arange(256).astype(np.int8).astype(np.float32) + off
            if wire_bits == 4:
                # +/-2.5 sigma of the CENTERED signal onto [-7, 7]; one
                # byte -> nibble LUT packs each plane with a single gather
                step = max(2.5 * sigma / 7.0, 0.25)
                pack_lut = np.clip(np.round(vals / step), -8,
                                   7).astype(np.int8)
                conv = ("i4", np.float32(step * scale))
            elif wire_bits == 2:
                # optimal 4-level quantizer: levels (2q+1)*delta,
                # delta ~= 0.59 sigma, thresholds at {-2, 0, +2} delta
                delta = max(0.59 * sigma, 0.25)
                pack_lut = np.clip(np.floor(vals / (2.0 * delta)), -2,
                                   1).astype(np.int8)
                conv = ("i2", np.float32(delta * scale))
            else:
                # sign quantizer: levels +/-delta, delta = E|x| of the
                # Gaussian = 0.7979 sigma (minimum-MSE 1-bit level);
                # ~1.96 dB C/N0 cost, an eighth of the bytes
                delta = max(0.7979 * sigma, 0.25)
                pack_lut = np.clip(np.floor(vals / (2.0 * delta)), -1,
                                   0).astype(np.int8)
                conv = ("i1", np.float32(delta * scale))
        elif wire_bits == 8:
            conv = ("i8", np.float32(off), np.float32(scale))
        else:
            raise ValueError(
                f"wire_bits must be 'auto', 8, 4, 2 or 1, got {wire_bits}")
        if wire_bits != 8 and W % (8 // wire_bits):
            raise ValueError(
                f"wire_bits={wire_bits} needs the segment window "
                f"({W} samples) divisible by {8 // wire_bits}; use "
                f"wire_bits=8 for this sample rate / segment length")
        if conv != self._ingest_conv:
            # the conversion constants are baked into the traced fns —
            # re-wrap the jits when a reused receiver switches convention
            self._ingest_conv = conv
            self._jit_run = jax.jit(self._run_packed_fn)
            self._jit_acquire = jax.jit(self._acquire_packed)
            self._jit_refine = jax.jit(self._refine_traced)

        reader = CaptureReader(path, block_samples=S)
        it = iter(reader)
        buf: dict[int, np.ndarray] = {}        # block idx -> (2, S) int8
        next_blk = 0

        def fetch_upto(b, keep_from):
            # on resume the reader still walks the file prefix (it is
            # sequential), but blocks before keep_from are DROPPED —
            # buffering them would hold the whole prefix in host memory
            nonlocal next_blk
            while next_blk <= b:
                try:
                    _, blk = next(it)
                except StopIteration:
                    break
                if next_blk >= keep_from:
                    buf[next_blk] = blk
                next_blk += 1

        def get_window(seg):
            fetch_upto(seg + 1, seg)
            head = buf.get(seg)
            tail = buf.get(seg + 1)
            # int8 planes: the jitted consumers convert on device, so the
            # upload is a quarter of float32 planes
            w = np.zeros((2, W), np.int8)
            if head is not None:
                m = min(head.shape[1], W)
                w[:, :m] = head[:, :m]
            if tail is not None and W > S:
                m = min(tail.shape[1], W - S)
                w[:, S:S + m] = tail[:, :m]
            for k in [k for k in buf if k < seg]:
                buf.pop(k)                     # keep only seg, seg+1
            if pack_lut is not None:
                # BLOCK layout to match _ingest's concat unpack: byte j
                # carries samples {j + k*W*bits/8} — one fused C++ pass
                # when the native reader is built, numpy fallback below
                bits = {"i4": 4, "i2": 2, "i1": 1}[conv[0]]
                from ..native import reader as native_reader
                if native_reader.quantpack_available():
                    w = native_reader.quantpack(w, pack_lut, bits)
                else:
                    q = pack_lut[w.view(np.uint8)]
                    if conv[0] == "i4":
                        h = W // 2
                        w = ((q[:, :h] & 15)
                             | (q[:, h:] << 4)).astype(np.int8)
                    elif conv[0] == "i2":  # four samples per byte
                        qr = q.reshape(2, 4, W // 4)
                        w = ((qr[:, 0] & 3) | ((qr[:, 1] & 3) << 2)
                             | ((qr[:, 2] & 3) << 4)
                             | (qr[:, 3] << 6)).astype(np.int8)
                    else:                  # i1: eight sign bits per byte
                        qr = q.reshape(2, 8, W // 8).view(np.uint8)
                        acc = np.zeros((2, W // 8), np.uint8)
                        for k in range(8):
                            acc |= (qr[:, k] & 1) << k
                        w = acc.view(np.int8)
            d = jax.device_put(w)          # ONE transfer for both planes
            # force the copy NOW, on this IO worker thread: the runtime
            # defers host->device transfers to the first consumer, which
            # would serialize the whole upload into the NEXT segment's
            # result fetch instead of overlapping it with compute
            np.asarray(d[0, :1])
            return seg * S, cplx.CArray(d[0], d[1])

        try:
            return self._process_core(get_window, n_seg, verbose,
                                      segment_cb=segment_cb, ckpt=ckpt)
        finally:
            # drain the single IO worker before closing: an in-flight
            # get_window (e.g. after a segment_cb abort) must not race a
            # closed native reader handle
            self._io_pool.submit(lambda: None).result()
            reader.close()

    def _process_core(self, get_window, n_seg: int,
                      verbose: bool = False,
                      segment_cb=None, ckpt=None) -> ReceiverResult:
        log = print if verbose else (lambda *a: None)
        su = self.su
        ids = su["ids"]

        # slot bookkeeping (host)
        slot_sat = np.zeros(self.n_slots, np.int64)        # 0 = free
        slot_next = np.zeros(self.n_slots, np.int64)       # next win start
        slot_birth = np.zeros(self.n_slots, np.int64)      # global epoch
        slot_bad = np.zeros(self.n_slots, np.int64)        # bad segments
        # nav-health probe bookkeeping: last global epoch covered by a
        # successful decode probe of the slot's open interval (-1 = never)
        slot_obs_end = np.full(self.n_slots, -1, np.int64)
        st = tracking.init_state(
            self.n_slots, np.zeros(self.n_slots, np.float32),
            np.zeros(self.n_slots, np.float32), self.fs,
            code_len=su["code_len"], chip_rate=su["chip_rate"])
        tab = np.zeros((self.n_slots, su["code_len"]), np.float32)
        carr = np.full(self.n_slots, 1575.42e6, np.float32)
        offhz = np.zeros(self.n_slots, np.float32)

        intervals: list[SlotInterval] = []
        open_iv: dict[int, SlotInterval] = {}
        acq_seen: dict[int, ChannelResult] = {}
        # cache is per-run: a reused receiver on another capture must not
        # serve stale observables — drain the decode worker (so no stale
        # in-flight build repopulates the cache), then clear
        self._dec_pool.submit(lambda: None).result()
        self._obs_cache.clear()
        self._obs_inflight.clear()
        total_epochs = n_seg * self.seg_epochs
        # full-timeline telemetry sources (ReceiverResult.cn0_epochs /
        # tracked_spans): C/N0 accumulates over every ACTIVE slot each
        # segment — including the jam-crushed segments later trimmed from
        # the decode intervals — so the telemetry F2 evidence survives
        spans: list[tuple[int, int, int]] = []
        cn0_sum = np.zeros(total_epochs, np.float64)
        cn0_cnt = np.zeros(total_epochs, np.int64)
        acq_next_seg = 0                       # acquisition holdoff gate
        self._probe_fix = None         # last probe-round WLS position

        start_seg = 0
        if ckpt is not None and ckpt.get("state"):
            s0 = ckpt["state"]
            meta = s0.get("meta", {})
            want = {"fs": self.fs, "system": self.system,
                    "seg_epochs": self.seg_epochs,
                    "n_slots": self.n_slots,
                    "pvt_filter": self.pvt_filter,
                    "conv": self._ingest_conv,
                    "probe_every": self.probe_every}
            if meta != want:
                raise ValueError(
                    f"checkpoint incompatible with this receiver: "
                    f"saved {meta}, expected {want}")
            start_seg = s0["next_seg"]
            slot_sat[:] = s0["slot_sat"]
            slot_next[:] = s0["slot_next"]
            slot_birth[:] = s0["slot_birth"]
            slot_bad[:] = s0["slot_bad"]
            slot_obs_end[:] = s0["slot_obs_end"]
            tab[:] = s0["tab"]
            carr[:] = s0["carr"]
            offhz[:] = s0["offhz"]
            st = type(st)(**{f: jnp.asarray(v)
                             for f, v in s0["st"].items()})
            intervals.extend(s0["intervals"])
            open_iv.update(s0["open_iv"])
            acq_seen.update(s0["acq_seen"])
            spans.extend(s0["spans"])
            m = min(s0["cn0_sum"].size, cn0_sum.size)
            cn0_sum[:m] = s0["cn0_sum"][:m]
            cn0_cnt[:m] = s0["cn0_cnt"][:m]
            acq_next_seg = s0["acq_next_seg"]
            self._probe_fix = s0["probe_fix_pos"]
            self._dev_tabs = None

        def save_checkpoint(next_seg: int) -> None:
            """Atomic pickle of the full receiver state at a segment
            boundary (arrays copied; interval data arrays are replaced,
            never mutated in place, so sharing them is safe)."""
            import pickle
            import tempfile
            state = {
                "meta": {"fs": self.fs, "system": self.system,
                         "seg_epochs": self.seg_epochs,
                         "n_slots": self.n_slots,
                         "pvt_filter": self.pvt_filter,
                         "conv": self._ingest_conv,
                         "probe_every": self.probe_every},
                "next_seg": next_seg,
                "slot_sat": slot_sat.copy(),
                "slot_next": slot_next.copy(),
                "slot_birth": slot_birth.copy(),
                "slot_bad": slot_bad.copy(),
                "slot_obs_end": slot_obs_end.copy(),
                "probe_fix_pos": (None if self._probe_fix is None
                                  else self._probe_fix.copy()),
                "tab": tab.copy(), "carr": carr.copy(),
                "offhz": offhz.copy(),
                "st": {f: np.asarray(getattr(st, f))
                       for f in st._fields},
                "intervals": list(intervals),
                "open_iv": {k: dataclasses.replace(v)
                            for k, v in open_iv.items()},
                "acq_seen": {k: dataclasses.replace(v)
                             for k, v in acq_seen.items()},
                "spans": list(spans),
                "cn0_sum": cn0_sum.copy(),
                "cn0_cnt": cn0_cnt.copy(),
                "acq_next_seg": acq_next_seg,
            }
            d = os.path.dirname(os.path.abspath(ckpt["path"]))
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    pickle.dump(state, f)
                os.replace(tmp, ckpt["path"])
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise

        def close(slot, trim_epochs: int = 0):
            iv = open_iv.pop(slot, None)
            if iv is None:
                return
            if trim_epochs and iv.n_epochs > trim_epochs:
                # drop the unhealthy tail (the segments that triggered the
                # reset) so jam-corrupted epochs don't poison bit sync
                keep = iv.n_epochs - trim_epochs
                for name in ("i_prompt", "code_rem", "carr_freq", "cn0"):
                    arr = getattr(iv, name)
                    if arr is not None:
                        setattr(iv, name, arr[:keep])
                iv.n_epochs = keep
            # TRACKED| span = the HEALTHY extent (trimmed): the jam-
            # crushed tail leaves the telemetry tracked list when the
            # health check starts failing, so the thinning is visible
            # during the jam rather than only at the reset instant
            spans.append((iv.sat_id, iv.start_epoch,
                          iv.start_epoch + iv.n_epochs))
            intervals.append(iv)
            # warm the final decode off the critical path (same gates as
            # _decode_pvt, so crushed intervals don't burn worker time)
            skip_w = max(int(round(1000.0 / self.su["epoch_ms"])), 1)
            if iv.n_epochs > skip_w + 1 and \
                    float(np.median(iv.cn0[-200:])) >= self.min_cn0:
                self._submit_obs(dataclasses.replace(iv), iv.n_epochs)

        # ---- nav-health probe machinery ---------------------------------
        # Every probe_every segments the decode worker bit-syncs/decodes
        # each open interval's full prefix (also warming _obs_cache for
        # live snapshots and the final decode). Results are consumed
        # EXACTLY one segment later — deterministic, so checkpoint/resume
        # reproduces the same reset decisions bitwise (in-flight probes
        # at a checkpoint boundary are re-submitted from restored state).
        probe_pending: list[tuple] = []
        ms = self.su["epoch_ms"]
        skip = max(int(round(1000.0 / ms)), 1)
        wk_adj = {"gps": 2048, "galileo": 1024}.get(self.system, 0)

        def submit_probes(seg):
            if self.system == "sbas":
                # message channel: no eph/week/elevation to probe — the
                # C/N0 check is the health authority (matching the
                # reference's SBAS channel, which has no precheck gates)
                return
            for s in sorted(open_iv):
                iv = open_iv[s]
                if iv.n_epochs <= skip + 1:
                    continue
                snap = dataclasses.replace(iv)
                fut = self._submit_obs(snap, snap.n_epochs)
                probe_pending.append((s, snap.sat_id, snap.start_epoch,
                                      snap.n_epochs, fut))

        def eval_probes(seg):
            nonlocal acq_next_seg
            seg_ep = seg * self.seg_epochs
            fix_obs: list = []
            fix_starts: list[int] = []
            resets: list[tuple[int, str]] = []
            pending, probe_pending[:] = list(probe_pending), []
            for s, sat, st0, n_use, fut in pending:
                obs = fut.result()
                if slot_sat[s] != sat or s not in open_iv \
                        or open_iv[s].start_epoch != st0:
                    continue               # slot reset/reassigned meanwhile
                age_s = (seg_ep - slot_birth[s]) * ms * 1e-3
                cause = None
                if obs is None:
                    if slot_obs_end[s] < 0:
                        # never decoded: the ghost-peak reset
                        # (sdrmain.c:263-340 "nav not decoded" branch)
                        if age_s >= self.reset_nodecode_s:
                            cause = "nodecode"
                    elif (seg_ep - slot_obs_end[s]) * ms * 1e-3 \
                            >= self.reset_obs_stale_s:
                        # decoded before, none since: checkObsDelay
                        # stale-observable reset (sdrmain.c:464-511)
                        cause = "obs_stale"
                else:
                    slot_obs_end[s] = st0 + n_use
                    week = int(getattr(obs.eph, "week", 0) or 0)
                    complete = _eph_complete(self.system, obs.eph)
                    if wk_adj and week and complete \
                            and week + wk_adj < self.reset_week_min:
                        # stale/implausible week (sdr.h week gate)
                        cause = "week"
                    elif complete and self._probe_fix is not None:
                        local = min(n_use - 1, seg_ep - st0)
                        el = self._sat_elevation(obs, local,
                                                 self._probe_fix)
                        if el < self.reset_elevation_deg:
                            # below the reference's 12 deg tracking mask
                            cause = "elevation"
                    if cause is None and complete:
                        fix_obs.append(obs)
                        fix_starts.append(st0)
                if cause is not None:
                    resets.append((s, cause))
            for s, cause in resets:
                log(f"[seg {seg}] reset slot {s} "
                    f"(sat {slot_sat[s]}, cause {cause})")
                slot_sat[s] = 0
                slot_obs_end[s] = -1
                close(s)
                acq_next_seg = seg             # re-arm the search now
            # single-epoch WLS at the probe horizon: feeds the NEXT
            # round's elevation checks (the reference needs a fix for its
            # elevation reset too — az/el come from the PVT obs matrix)
            if len(fix_obs) >= 4:
                m = seg_ep - 1
                meas = self._epoch_meas(fix_obs, fix_starts, m, skip)
                if meas is not None and meas[4].sum() >= 4:
                    _, pos, pr, clk, mask = meas
                    sol = pvt.solve_wls(pos, pr, clk, mask=mask)
                    if sol.valid:
                        self._probe_fix = np.asarray(sol.pos_ecef)

        import time as _time
        prof = {"win_wait": 0.0, "probes": 0.0, "acquire": 0.0,
                "scan": 0.0, "book": 0.0, "ckpt_cb": 0.0,
                "final_decode": 0.0, "n_acquire_calls": 0}
        self.last_profile = prof

        if start_seg > 0 and (start_seg - 1) % self.probe_every == 0:
            submit_probes(start_seg - 1)       # in flight at the ckpt
            # boundary when saved; re-submitted from restored state so
            # resume reproduces the same (deterministic) reset decisions
        win_fut = (self._io_pool.submit(get_window, start_seg)
                   if n_seg > start_seg else None)
        for seg in range(start_seg, n_seg):
            seg_ep = seg * self.seg_epochs
            seg_start = seg_ep * self.n_epoch
            # pipelined window: segment k's window was assembled+uploaded
            # by the IO worker while segment k-1 computed; kick off k+1
            # NOW so its upload overlaps this segment's acquisition
            # round-trip + tracking scan (the datathread role,
            # sdrmain.c:402-415)
            pt0 = _time.perf_counter()
            base, xw = win_fut.result()
            pt1 = _time.perf_counter()
            prof["win_wait"] += pt1 - pt0
            # nav-health probe results from the previous segment's submit
            if probe_pending:
                eval_probes(seg)
            pt2 = _time.perf_counter()
            prof["probes"] += pt2 - pt1

            # ---- fill free slots from a fresh acquisition ---------------
            free = [s for s in range(self.n_slots) if slot_sat[s] == 0]
            if free and seg >= acq_next_seg:
                prof["n_acquire_calls"] += 1
                packed_acq = self._acquire(xw, seg_start - base)
                acq = packed_acq[0] > 0.5
                lags = packed_acq[1]
                dopp = packed_acq[2]
                ratios = packed_acq[3]
                cn0s = packed_acq[4]
                active = set(int(v) for v in slot_sat if v != 0)
                cands = [i for i in np.argsort(-ratios)
                         if acq[i] and ids[i] not in active]
                new_idx = cands[: len(free)]
                # search again next segment only when this round left
                # above-threshold candidates on the table (more sats
                # than free slots); if every candidate got a slot, the
                # sky is swept — hold off like a failed search (each
                # empty search costs a dispatch + fetch round trip)
                acq_next_seg = (seg + 1 if len(cands) > len(free)
                                else seg + self.acq_holdoff)
                if new_idx:
                    t2, c2, o2 = _system_tables(
                        self.system, [ids[i] for i in new_idx])
                    eff = dopp[new_idx].astype(np.float32)
                    if o2 is not None:
                        eff = eff + o2
                    # round the (float32-fetched) lag BEFORE the int64
                    # add: f32 spacing at 63M samples is 4, which would
                    # bias the re-acquired code phase by whole samples
                    abs_lag = (np.round(lags[new_idx]).astype(np.int64)
                               + seg_start)
                    fine = self._refine(
                        xw, t2, (abs_lag - base).astype(np.int32), eff,
                        c2, o2)
                    init2 = tracking.init_state(
                        len(new_idx),
                        fine - (o2 if o2 is not None else 0.0),
                        np.zeros(len(new_idx), np.float32), self.fs,
                        code_len=su["code_len"], chip_rate=su["chip_rate"],
                        carrier_hz=c2 if c2 is not None else 1575.42e6,
                        nominal_offset_hz=o2 if o2 is not None else 0.0)
                    # ONE stacked fetch for the whole tracking state
                    # instead of 11 per-field round trips per assignment
                    st_stack = np.array(jnp.stack(list(st)))  # writable
                    init_stack = np.asarray(jnp.stack(list(init2)))
                    st_h = type(st)(*st_stack)
                    init_h = type(init2)(*init_stack)
                    for j, (i, s) in enumerate(zip(new_idx, free)):
                        sat = ids[i]
                        slot_sat[s] = sat
                        slot_next[s] = int(abs_lag[j])
                        slot_birth[s] = seg_ep
                        slot_bad[s] = 0
                        slot_obs_end[s] = -1   # fresh decode horizon: the
                        # previous occupant's must not make the new sat
                        # instantly "obs_stale" before its nodecode grace
                        tab[s] = t2[j]
                        if c2 is not None:
                            carr[s] = c2[j]
                            offhz[s] = o2[j]
                        else:
                            carr[s] = 1575.42e6
                            offhz[s] = 0.0
                        for f in st_h._fields:
                            getattr(st_h, f)[s] = \
                                getattr(init_h, f)[j]
                        open_iv[s] = SlotInterval(
                            sat_id=sat, slot=s, start_epoch=seg_ep,
                            sample_offset=float(abs_lag[j]))
                        if sat not in acq_seen:
                            acq_seen[sat] = ChannelResult(
                                prn=sat, acquired=True,
                                doppler_hz=float(fine[j]),
                                code_phase_samples=float(lags[new_idx][j]),
                                peak_ratio=float(ratios[i]),
                                cn0_dbhz=float(cn0s[i]))
                    # ONE upload for the whole state; per-field device
                    # views are cheap dispatches, not round trips
                    dev = jnp.asarray(np.stack(list(st_h)))
                    st = type(st)(*[dev[fi] for fi in range(len(st_h))])
                    self._dev_tabs = None      # slot tables changed

            # ---- one tracking scan over the segment ---------------------
            pt3 = _time.perf_counter()
            prof["acquire"] += pt3 - pt2
            ages = (seg_ep - slot_birth).astype(np.int32)
            if self._dev_tabs is None:
                self._dev_tabs = (jnp.asarray(tab), jnp.asarray(carr),
                                  jnp.asarray(offhz))
            d_tab, d_carr, d_offhz = self._dev_tabs
            offs_ages = np.stack([(slot_next - base).astype(np.int32),
                                  ages.astype(np.int32)])
            st, packed = self._jit_run(
                st, xw, jnp.asarray(offs_ages), d_tab, d_carr, d_offhz)
            # submit the NEXT window only after this segment's last device
            # dispatch: the runtime's stream is IN-ORDER, so an upload
            # enqueued before this segment's acquisition/scan would stall
            # them behind the whole transfer; enqueued here it overlaps
            # the result fetch + host bookkeeping/decode instead
            if seg + 1 < n_seg:
                win_fut = self._io_pool.submit(get_window, seg + 1)
            packed = np.asarray(packed)        # one fetch for all streams
            ip, rem, cf, cn0 = packed
            slot_next += self.seg_epochs * self.n_epoch
            pt4 = _time.perf_counter()
            prof["scan"] += pt4 - pt3

            # ---- append outputs + health check --------------------------
            for s in list(open_iv):
                iv = open_iv[s]
                cn0_sum[seg_ep:seg_ep + self.seg_epochs] += cn0[:, s]
                cn0_cnt[seg_ep:seg_ep + self.seg_epochs] += 1
                for name, arr in (("i_prompt", ip), ("code_rem", rem),
                                  ("carr_freq", cf), ("cn0", cn0)):
                    prev = getattr(iv, name)
                    seg_arr = arr[:, s]
                    setattr(iv, name,
                            seg_arr if prev is None
                            else np.concatenate([prev, seg_arr]))
                iv.n_epochs += self.seg_epochs
                # whole-segment LOWER QUARTILE: under strong jamming the
                # C/N0 estimator oscillates epoch-to-epoch between deep
                # nulls and spurious healthy-looking values, so both a
                # short tail window and the segment median can land above
                # the reset threshold while the channel is actually dead
                # (observed with clipped broadband jam at 4 s segments).
                # p25 stays ~48 dB-Hz for a genuinely locked channel and
                # collapses when >=25% of the segment is crushed.
                med = float(np.percentile(cn0[:, s], 25.0))
                aged = seg_ep - slot_birth[s] >= self.seg_epochs
                if not med >= self.reset_cn0 and aged:
                    slot_bad[s] += 1
                else:
                    slot_bad[s] = 0
                if slot_bad[s] > self.grace:
                    # health reset (resetStructs role): free the slot
                    log(f"[seg {seg}] reset slot {s} "
                        f"(sat {slot_sat[s]}, med cn0 {med:.1f})")
                    slot_sat[s] = 0
                    slot_obs_end[s] = -1
                    close(s, trim_epochs=int(slot_bad[s])
                          * self.seg_epochs)
                    acq_next_seg = seg + 1     # search freed slot now
            log(f"[seg {seg}] slots: "
                + ",".join(str(v) for v in slot_sat)
                + " cn0tail: "
                + ",".join(
                    f"{float(np.median(cn0[-200:, s])):.0f}"
                    for s in range(self.n_slots))
                + " bad: " + ",".join(str(v) for v in slot_bad))
            prof["book"] += _time.perf_counter() - pt4
            pt5 = _time.perf_counter()
            if ckpt is not None and (seg + 1) % ckpt["every"] == 0 \
                    and seg + 1 < n_seg:
                save_checkpoint(seg + 1)
            if seg % self.probe_every == 0 and seg + 1 < n_seg:
                submit_probes(seg)             # evaluated next segment
            if segment_cb is not None:
                def snapshot(_upto=(seg + 1) * self.seg_epochs):
                    """Decode + PVT over the data so far (pure function
                    of the interval snapshots; arrays are replaced, never
                    mutated, per segment, so sharing them is safe)."""
                    ivs = [iv for iv in intervals]
                    sp = list(spans)
                    for oiv in open_iv.values():
                        ivs.append(dataclasses.replace(oiv))
                        sp.append((oiv.sat_id, oiv.start_epoch,
                                   oiv.start_epoch + oiv.n_epochs))
                    return self._decode_pvt(
                        ivs, acq_seen, sp, cn0_sum, cn0_cnt, _upto,
                        prefix_bucket=4 * self.seg_epochs)
                segment_cb(seg + 1, n_seg, snapshot)
            prof["ckpt_cb"] += _time.perf_counter() - pt5
        for s in list(open_iv):
            close(s)
        self.last_intervals = intervals
        pt6 = _time.perf_counter()
        out = self._decode_pvt(intervals, acq_seen, spans,
                               cn0_sum, cn0_cnt, total_epochs)
        prof["final_decode"] = _time.perf_counter() - pt6
        return out

    # -- interval decode (worker-shared, cached) --------------------------
    def _submit_obs(self, iv: SlotInterval, n_use: int):
        """Queue an interval-prefix decode on the decode worker; returns a
        Future (already-resolved when cached). Only the main thread
        submits, so the inflight map needs no submit-side locking."""
        import concurrent.futures as cf
        key = (iv.sat_id, iv.start_epoch, n_use)
        with self._obs_lock:
            cached = self._obs_cache.get(key, self._obs_lock)  # sentinel
        if cached is not self._obs_lock:
            fut = cf.Future()
            fut.set_result(cached)
            return fut
        fut = self._obs_inflight.get(key)
        if fut is None:
            fut = self._dec_pool.submit(self._build_obs, iv, n_use)
            self._obs_inflight[key] = fut
            fut.add_done_callback(
                lambda f, k=key: self._obs_inflight.pop(k, None))
        return fut

    def _build_obs(self, iv: SlotInterval, n_use: int):
        """Decode one interval prefix into ChannelObservables (bit sync ->
        nav frames -> timing anchor), memoized in _obs_cache. Runs on the
        decode worker (probes, closed-interval warming) AND synchronously
        from _decode_pvt; an in-flight duplicate is awaited, not redone."""
        key = (iv.sat_id, iv.start_epoch, n_use)
        with self._obs_lock:
            cached = self._obs_cache.get(key, self._obs_lock)
        if cached is not self._obs_lock:
            return cached
        fut = self._obs_inflight.get(key)
        if fut is not None and not fut.done() \
                and threading.current_thread().name[:6] != "rx-dec":
            return fut.result()
        skip_eps = max(int(round(1000.0 / self.su["epoch_ms"])), 1)
        if self.system == "sbas":
            # message channel (sdrnav_sbs.c:47-97 in-loop role): the
            # "observables" of an SBAS interval are its decoded messages
            obs = systems.decode_sbas_channel(
                iv.i_prompt[:n_use], skip_epochs=skip_eps) or None
            with self._obs_lock:
                for k in [k for k in self._obs_cache
                          if k[:2] == key[:2] and k[2] < n_use]:
                    del self._obs_cache[k]
                self._obs_cache[key] = obs
            return obs
        args = dict(i_prompt=iv.i_prompt[:n_use],
                    code_rem=iv.code_rem[:n_use],
                    carr_freq=iv.carr_freq[:n_use],
                    cn0=iv.cn0[:n_use],
                    skip_epochs=skip_eps,
                    sample_offset=iv.sample_offset
                    - iv.start_epoch * self.n_epoch,
                    epoch_samples=self.n_epoch)
        if self.system == "gps":
            obs = observables.build_channel_observables(
                prn=iv.sat_id, **args)
        elif self.system == "galileo":
            obs = systems.build_galileo_observables(prn=iv.sat_id, **args)
        else:
            obs = systems.build_glonass_observables(
                freq_ch=iv.sat_id, **args)
        with self._obs_lock:
            # supersede shorter prefixes of the same interval so the
            # cache stays O(n_intervals), not O(n * emissions)
            for k in [k for k in self._obs_cache
                      if k[:2] == key[:2] and k[2] < n_use]:
                del self._obs_cache[k]
            self._obs_cache[key] = obs
        return obs

    def _sat_elevation(self, obs, local_epoch: int,
                       fix_pos: np.ndarray) -> float:
        """Elevation [deg] of the satellite behind `obs` at its
        local_epoch, seen from fix_pos ECEF (the sdr.h:115-121 elevation
        health gate needs this; az/el via togeod/topocent in the
        reference, sdrpvt.c:845-967)."""
        t_tx = np.array([obs.transmit_time_common(local_epoch)])
        if self.system == "glonass":
            pos, _ = systems.glonass_sat_pos_clock([obs.eph], t_tx)
        else:
            batch = eph_mod.stack_ephemeris([obs.eph])
            pos, _ = eph_mod.sat_pos_clock(batch, t_tx)
        d = np.asarray(pos[0], np.float64) - np.asarray(fix_pos, np.float64)
        e, n, u = pvt.topocentric(np.asarray(fix_pos, np.float64), d)
        return float(np.degrees(np.arctan2(u, np.hypot(e, n))))

    def _epoch_meas(self, live, live_start, m: int, skip: int):
        """Measurements for one PVT epoch m over the decoded channels:
        (chs, sat_pos, pseudoranges, sat_clk, precheck mask) — the
        sdrsync.c:47-124 common-ToW alignment + sdrpvt.c:612-762 gates.
        Returns None when no channel covers the epoch."""
        idx = [k for k, (ch, st0) in enumerate(zip(live, live_start))
               if st0 + skip < m < st0 + ch.chips.size]
        if not idx:
            return None
        chs = [live[k] for k in idx]
        local = [m - live_start[k] for k in idx]
        t_tx = np.array([ch.transmit_time_common(lm)
                         for ch, lm in zip(chs, local)])
        t_rx = t_tx.min() + observables.PTIMING_S
        pr = 299_792_458.0 * (t_rx - t_tx)
        if self.system == "glonass":
            pos, clk = systems.glonass_sat_pos_clock(
                [ch.eph for ch in chs], t_tx)
            weeks = np.full(len(chs), 2400)
        else:
            batch = eph_mod.stack_ephemeris([ch.eph for ch in chs])
            pos, clk = eph_mod.sat_pos_clock(batch, t_tx)
            wk_adj = 2048 if self.system == "gps" else 1024
            weeks = np.array([ch.eph.week for ch in chs]) + wk_adj
        snr = np.array([ch.cn0_dbhz[lm] for ch, lm in zip(chs, local)])
        mask = pvt.precheck_mask(
            snr_dbhz=snr, week=weeks, tow_s=t_tx, pr_m=pr,
            eph_complete=[_eph_complete(self.system, ch.eph)
                          for ch in chs])
        return chs, pos, pr, clk, mask

    def _decode_sbas(self, intervals, acq_seen, spans, cn0_sum, cn0_cnt,
                     upto_epochs: int,
                     prefix_bucket: int | None = None) -> ReceiverResult:
        """SBAS streaming decode: per-interval symbol sync + continuous
        FEC + MT decode (sdrnav_sbs.c:47-97 as an in-loop channel); no
        PVT — message monitoring only, like the reference."""
        skip = max(int(round(1000.0 / self.su["epoch_ms"])), 1)
        channels = {sat: dataclasses.replace(res)
                    for sat, res in acq_seen.items()}
        for iv in sorted(intervals, key=lambda iv: iv.start_epoch):
            n_use = iv.n_epochs
            if prefix_bucket:
                n_use = (n_use // prefix_bucket) * prefix_bucket
            if n_use <= skip + 1:
                continue
            if float(np.median(iv.cn0[:n_use][-200:])) < self.min_cn0:
                continue
            msgs = self._build_obs(iv, n_use)
            if not msgs:
                continue
            ch = channels.get(iv.sat_id)
            if ch is not None:
                seen = {(m.mt, round(m.tow_s, 3))
                        for m in (ch.messages or [])}
                ch.messages = (ch.messages or []) + [
                    m for m in msgs
                    if (m.mt, round(m.tow_s, 3)) not in seen]
        cn0_epochs = (cn0_sum[:upto_epochs]
                      / np.maximum(cn0_cnt[:upto_epochs], 1))
        return ReceiverResult(list(channels.values()), [], [],
                              self.system, self.su["epoch_ms"], "WLS",
                              cn0_epochs=cn0_epochs.astype(np.float32),
                              tracked_spans=spans, obs_spans=None)

    def _decode_pvt(self, intervals, acq_seen, spans, cn0_sum, cn0_cnt,
                    upto_epochs: int,
                    prefix_bucket: int | None = None) -> ReceiverResult:
        """Decode the tracking intervals and run PVT up to `upto_epochs`.

        Pure with respect to its inputs (fresh ChannelResult copies, fresh
        EKF), so the live-telemetry path can call it on a mid-run snapshot
        every few segments (the sdrout.c 100 ms status role) and the final
        call still produces the authoritative result."""
        su = self.su
        log = lambda *a: None  # noqa: E731 — quiet in snapshot mode

        if self.system == "sbas":
            return self._decode_sbas(intervals, acq_seen, spans,
                                     cn0_sum, cn0_cnt, upto_epochs,
                                     prefix_bucket)

        # ---- decode each interval ----------------------------------------
        skip = max(int(round(1000.0 / su["epoch_ms"])), 1)
        channels: dict[int, ChannelResult] = {
            sat: dataclasses.replace(res) for sat, res in acq_seen.items()}
        intervals = sorted(intervals, key=lambda iv: iv.start_epoch)
        live: list[observables.ChannelObservables] = []
        live_start: list[int] = []
        obs_spans: list[tuple[int, object]] = []
        eph_cache: dict[int, object] = {}
        for iv in intervals:
            n_use = iv.n_epochs
            if prefix_bucket:
                n_use = (n_use // prefix_bucket) * prefix_bucket
            if n_use <= skip + 1:
                continue
            if float(np.median(iv.cn0[:n_use][-200:])) < self.min_cn0:
                continue
            obs = self._build_obs(iv, n_use)
            log(f"interval sat {iv.sat_id} slot {iv.slot} "
                f"start_ep {iv.start_epoch} n {iv.n_epochs} "
                f"obs {'OK' if obs is not None else 'None'} "
                f"cn0med {float(np.median(iv.cn0[-200:])):.1f}")
            if obs is None:
                continue
            # ephemeris persists across channel resets (the reference
            # keeps sdreph_t across resetStructs): a short post-reset
            # interval re-anchors timing from one subframe/page/string
            # and reuses the cached broadcast ephemeris.
            if _eph_complete(self.system, obs.eph):
                eph_cache[iv.sat_id] = obs.eph
            elif iv.sat_id in eph_cache:
                obs.eph = eph_cache[iv.sat_id]
            obs_spans.append((iv.start_epoch, obs))
            if channels.get(iv.sat_id) is not None \
                    and channels[iv.sat_id].obs is None:
                channels[iv.sat_id].obs = obs
            if _eph_complete(self.system, obs.eph):
                live.append(obs)
                live_start.append(iv.start_epoch)

        # ---- PVT over whichever channels cover each epoch ---------------
        # pvt_filter='ekf': the 8-state pseudorange EKF (pvt.PvtEkf) is
        # seeded by the first WLS fix and then COASTS through epochs with
        # <4 healthy channels (jam windows) — the availability the
        # reference's empty EKF branch reserves (sdrpvt.c:85-88,
        # sdr.h:381-384) but never delivers.
        fixes: list[pvt.PvtSolution] = []
        fix_epochs: list[int] = []
        interval_ep = max(int(round(200.0 / su["epoch_ms"])), 1)
        ekf = pvt.PvtEkf() if self.pvt_filter == "ekf" else None
        last_m: int | None = None
        for m in range(interval_ep, upto_epochs, interval_ep):
            idx = [k for k, (ch, st0) in enumerate(zip(live, live_start))
                   if st0 + skip < m < st0 + ch.chips.size]
            ekf_live = ekf is not None and ekf.initialized
            if len(idx) < 4 and not ekf_live:
                continue
            chs = [live[k] for k in idx]
            local = [m - live_start[k] for k in idx]
            t_tx = np.array([ch.transmit_time_common(lm)
                             for ch, lm in zip(chs, local)])
            if chs:
                t_rx = t_tx.min() + observables.PTIMING_S
                pr = 299_792_458.0 * (t_rx - t_tx)
                if self.system == "glonass":
                    pos, clk = systems.glonass_sat_pos_clock(
                        [ch.eph for ch in chs], t_tx)
                    weeks = np.full(len(chs), 2400)
                else:
                    batch = eph_mod.stack_ephemeris([ch.eph for ch in chs])
                    pos, clk = eph_mod.sat_pos_clock(batch, t_tx)
                    wk_adj = 2048 if self.system == "gps" else 1024
                    weeks = np.array([ch.eph.week for ch in chs]) + wk_adj
                snr = np.array([ch.cn0_dbhz[lm]
                                for ch, lm in zip(chs, local)])
                mask = pvt.precheck_mask(
                    snr_dbhz=snr, week=weeks, tow_s=t_tx, pr_m=pr,
                    eph_complete=[_eph_complete(self.system, ch.eph)
                                  for ch in chs])
            else:                              # coast-only epoch
                pos = np.zeros((0, 3))
                pr = np.zeros(0)
                clk = np.zeros(0)
                mask = np.zeros(0, bool)
            if ekf_live:
                dt = ((m - last_m) if last_m is not None else interval_ep) \
                    * su["epoch_ms"] * 1e-3
                sol = ekf.step(pos, pr, clk, mask=mask, dt_s=dt)
                last_m = m                     # the predict already ran
                if not sol.valid:
                    continue                   # coast limit exceeded
            else:
                if mask.sum() < 4:
                    continue
                sol = pvt.solve_wls(pos, pr, clk, mask=mask)
                if ekf is not None and sol.valid:
                    ekf.initialize(sol)
                last_m = m
            sol = sol._replace(prns=np.array([ch.prn for ch in chs]))
            fixes.append(sol)
            fix_epochs.append(int(round(m * su["epoch_ms"])))

        chan_list = list(channels.values())
        cn0_epochs = (cn0_sum[:upto_epochs]
                      / np.maximum(cn0_cnt[:upto_epochs], 1))
        return ReceiverResult(chan_list, fixes, fix_epochs, self.system,
                              su["epoch_ms"],
                              "EKF" if ekf is not None else "WLS",
                              cn0_epochs=cn0_epochs.astype(np.float32),
                              tracked_spans=spans, obs_spans=obs_spans)
