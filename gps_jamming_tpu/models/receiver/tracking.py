"""Code/carrier tracking: scan-structured PLL/DLL/FLL channel loops.

Batched re-design of `sdrtrk.c` (+ `correlator`, sdrcmn.c:707-740). The
reference runs one pthread per channel, each epoch grabbing a variable-length
window (`currnsamp`) so every correlation spans exactly one code period, then
updating PLL/DLL NCOs (sdrtrk.c:66-109). That variable-length grab is hostile
to XLA's static shapes, so this module uses the fixed-rate reformulation
(SURVEY.md §7 hard parts): every epoch processes a FIXED window of
`n_epoch = fs * 1 ms` samples, and the code phase lives entirely in the carry
state as a fractional chip remainder (`code_rem`), advanced by the tracked
code frequency each epoch. Observables read sub-chip code phase from the
carry instead of from a sample counter.

Structure: `lax.scan` over epochs; the carry is batched over channels so one
scan tracks the whole constellation. Per epoch, per channel:
  1. carrier wipe-off: planar NCO phasor (mixcarr, sdrcmn.c:581-705),
  2. tap correlations: (2*n_taps+1) shifted code replicas x mixed signal as
     one batched contraction (dot_21/22/23, sdrcmn.c:251-358),
  3. discriminators + 2nd-order loop filters (pll/dll, sdrtrk.c:66-109) with
     the 0.53-rule coefficients of sdrinit.c:187-207,
  4. FLL assist during pull-in, switch to locked bandwidths after
     `pullin_ms` (sdrinit.c:27-32).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ...config import TrackingConfig
from ...ops import cplx
from ...ops import codes as codes_ops
from ...utils import constants as C


class LoopCoeffs(NamedTuple):
    """2nd-order loop filter coefficients (SoftGNSS/Kaplan form)."""
    c1: jax.Array   # proportional: applied to (err - err_prev)
    c2: jax.Array   # integral: applied to err * 1 (per-epoch)


def loop_coeffs(bw_hz: float, damping: float, dt: float,
                gain: float = 1.0) -> tuple[float, float]:
    """Classic 0.53-rule coefficients: wn = bw/0.53 (sdrinit.c:187-207).

    tau1 = gain / wn^2, tau2 = 2*damping/wn;
    update: freq += c1*(e - e_prev) + c2*e  with c1 = tau2/tau1,
    c2 = dt/tau1.
    """
    wn = bw_hz / 0.53
    tau1 = gain / (wn * wn)
    tau2 = 2.0 * damping / wn
    return tau2 / tau1, dt / tau1


class TrackState(NamedTuple):
    """Per-channel tracking carry (all arrays shape (n_ch,))."""
    carr_freq_hz: jax.Array      # carrier Doppler estimate
    carr_phase_rad: jax.Array    # NCO phase at window start
    code_freq_hz: jax.Array      # code NCO frequency
    code_nco_hz: jax.Array       # accumulated DLL correction [Hz]
    code_rem_chips: jax.Array    # code phase (chips) at window start
    perr_prev: jax.Array         # previous PLL discriminator
    derr_prev: jax.Array         # previous DLL discriminator
    ip_prev: jax.Array           # previous prompt I (FLL)
    qp_prev: jax.Array           # previous prompt Q (FLL)
    noise_ema: jax.Array         # off-peak power EMA (C/N0 denominator)
    sig_ema: jax.Array           # prompt power EMA (C/N0 numerator)


class TrackOutputs(NamedTuple):
    """Per-epoch outputs (stacked by scan: (n_epochs, n_ch))."""
    i_prompt: jax.Array
    q_prompt: jax.Array
    carr_freq_hz: jax.Array
    code_freq_hz: jax.Array
    code_rem_chips: jax.Array
    carr_phase_rad: jax.Array
    cn0_dbhz: jax.Array
    perr: jax.Array
    derr: jax.Array


def init_state(n_ch: int, doppler_hz, code_phase_samples, sample_rate: float,
               code_len: int = C.GPS_CA_CODE_LEN,
               chip_rate: float = C.GPS_CA_CHIP_RATE_HZ,
               carrier_hz=C.GPS_L1_FREQ_HZ,
               nominal_offset_hz=0.0) -> TrackState:
    """Seed tracking state from acquisition results.

    `code_phase_samples` is the acquisition peak lag: the sample index within
    the block where the code begins (sdracq.c -> sdrtrk handover). The code
    phase at window start (sample 0) is therefore -lag in chips, i.e.
    code_len - lag*chips_per_sample (mod code_len).

    `doppler_hz` is the true Doppler relative to each channel's carrier;
    `nominal_offset_hz` (scalar or per-channel) is a static baseband offset
    the carrier NCO must also track — the GLONASS FDMA channel offset after
    front-end mix-down (sdrinit.c:391-399). The stored carr_freq state is
    offset + Doppler; code aiding subtracts the offset (see make_tracker).
    """
    doppler = jnp.broadcast_to(jnp.asarray(doppler_hz, jnp.float32), (n_ch,))
    offset = jnp.broadcast_to(jnp.asarray(nominal_offset_hz, jnp.float32),
                              (n_ch,))
    carrier = jnp.broadcast_to(jnp.asarray(carrier_hz, jnp.float32), (n_ch,))
    lag = jnp.broadcast_to(jnp.asarray(code_phase_samples, jnp.float32),
                           (n_ch,))
    chips_per_sample = chip_rate / sample_rate
    rem = (-lag * chips_per_sample) % code_len
    # carrier-aided code frequency (sdrtrk.c:105-107)
    fcode = chip_rate * (1.0 + doppler / carrier)
    doppler = doppler + offset
    z = jnp.zeros((n_ch,), jnp.float32)
    return TrackState(
        carr_freq_hz=doppler, carr_phase_rad=z,
        code_freq_hz=jnp.broadcast_to(fcode, (n_ch,)).astype(jnp.float32),
        code_nco_hz=z, code_rem_chips=rem.astype(jnp.float32),
        perr_prev=z, derr_prev=z, ip_prev=z, qp_prev=z,
        noise_ema=jnp.ones((n_ch,), jnp.float32),
        sig_ema=jnp.ones((n_ch,), jnp.float32))


def _mix_nco(x: cplx.CArray, state: TrackState,
             sample_rate: float, n: int) -> cplx.CArray:
    """Carrier wipe-off per channel: x * e^{-j(phi + 2 pi f t)}."""
    t = jnp.arange(n, dtype=jnp.float32) / sample_rate
    phase = (state.carr_phase_rad[:, None]
             + 2.0 * jnp.pi * state.carr_freq_hz[:, None] * t[None, :])
    nco = cplx.expi(-phase)                                  # (n_ch, n)
    xb = cplx.apply(lambda a: a[None, :] if a.ndim == 1 else a, x)
    return cplx.mul(xb, nco)


def _corr_taps(taps: jax.Array, mixed: cplx.CArray):
    """(n_ch, n_tap, n) replicas x (n_ch, n) mixed -> (I, Q) (n_ch, n_tap)."""
    corr_i = jnp.einsum("ctn,cn->ct", taps, mixed.re,
                        preferred_element_type=jnp.float32)
    corr_q = jnp.einsum("ctn,cn->ct", taps, mixed.im,
                        preferred_element_type=jnp.float32)
    return corr_i, corr_q


def _tap_correlate(x: cplx.CArray, code_table: jax.Array, state: TrackState,
                   n_taps: int, tap_spacing: int, sample_rate: float,
                   code_len: int) -> tuple[jax.Array, jax.Array]:
    """All-tap correlation for every channel (exact gather formulation).

    x: (n,) planar window shared by all channels, or (n_ch, n)
    per-channel windows (code-phase-aligned gathers).
    code_table: (n_ch, code_len) +/-1 chips.
    Returns (I, Q) of shape (n_ch, 2*n_taps+1), taps ordered
    [-n_taps..+n_taps] * tap_spacing samples (early -> late).

    NOTE: the tracker uses the shift-based `_tap_correlate_base` path,
    which needs no per-epoch (n_ch, n_tap, n) gather, whenever
    the code period is an integer number of samples (all supported
    front-end configs). This exact path remains the oracle/fallback.
    """
    n = x.shape[-1]
    n_ch = code_table.shape[0]
    chips_per_sample = state.code_freq_hz / sample_rate      # (n_ch,)
    mixed = _mix_nco(x, state, sample_rate, n)

    # tap code replicas: chip phase per (channel, tap, sample)
    tap_off = (jnp.arange(-n_taps, n_taps + 1, dtype=jnp.float32)
               * tap_spacing)                                # samples
    # phase[ch, tap, i] = rem + (i + tap_off) * cps
    i_idx = jnp.arange(n, dtype=jnp.float32)
    chip_phase = (state.code_rem_chips[:, None, None]
                  + (i_idx[None, None, :] + tap_off[None, :, None])
                  * chips_per_sample[:, None, None])
    idx = jnp.floor(chip_phase).astype(jnp.int32) % code_len
    taps = jnp.take_along_axis(
        code_table[:, None, :], idx.reshape(n_ch, -1)[:, None, :], axis=-1
    ).reshape(n_ch, 2 * n_taps + 1, n)
    return _corr_taps(taps, mixed)


def resample_base_table(code_table: np.ndarray, chips_per_sample: float,
                        n_period: int, margin: int) -> np.ndarray:
    """Host-precomputed NN-resampled code, tiled for shift extraction.

    base[c, j] = chips[c, floor((j - margin) * cps) mod L] for
    j in [0, 2*n_period + 2*margin + 1): one code period resampled to the
    sample grid (the role of `rescode`, sdrcmn.c:527-579), tiled twice plus
    tap margin so any circular shift in [0, n_period) plus tap offsets in
    [-margin, margin] is a contiguous window.
    """
    n_ch, code_len = code_table.shape
    j = np.arange(2 * n_period + 2 * margin + 1)
    idx = np.floor((j - margin) * chips_per_sample).astype(np.int64) % code_len
    return np.ascontiguousarray(code_table[:, idx], dtype=np.float32)


def resample_base_table_jnp(code_table: jax.Array, chips_per_sample: float,
                            n_period: int, margin: int) -> jax.Array:
    """Device variant of `resample_base_table` for traced code tables.

    One gather per `run` call (outside the scan) instead of one per epoch.
    """
    code_len = code_table.shape[-1]
    j = np.arange(2 * n_period + 2 * margin + 1)
    idx = np.floor((j - margin) * chips_per_sample).astype(np.int64) % code_len
    return jnp.take(code_table, jnp.asarray(idx), axis=-1)


def _tap_correlate_base(x: cplx.CArray, base3: jax.Array, state: TrackState,
                        n_taps: int, tap_spacing: int, sample_rate: float,
                        chip_rate: float, n_period: int
                        ) -> tuple[jax.Array, jax.Array]:
    """Shift-based all-tap correlation (fast path, no per-epoch gather).

    The replica at code phase `rem` is a circular shift of the
    base-resampled code by sigma = rem/cps samples. The integer part is one
    dynamic slice per channel from the tiled base table; the fractional
    part linearly blends two adjacent shifts — a first-order-interpolated
    resampler, smoother than the reference's nearest-neighbor `rescode`
    (the DLL discriminator stays continuous in code phase). Chosen for
    the earlier accelerator's serialized gathers; not measured on H100.
    """
    n = x.shape[-1]
    cps0 = chip_rate / sample_rate
    margin = n_taps * tap_spacing
    mixed = _mix_nco(x, state, sample_rate, n)

    sigma = state.code_rem_chips / cps0                      # samples
    s = jnp.floor(sigma).astype(jnp.int32) % n_period
    lam = (sigma - jnp.floor(sigma)).astype(jnp.float32)

    win_len = n + 2 * margin + 1
    win = jax.vmap(
        lambda row, start: jax.lax.dynamic_slice(row, (start,), (win_len,))
    )(base3, s)                                              # (n_ch, win_len)
    blended = (1.0 - lam[:, None]) * win[:, :-1] + lam[:, None] * win[:, 1:]
    taps = jnp.stack(
        [jax.lax.slice_in_dim(blended, k * tap_spacing,
                              k * tap_spacing + n, axis=-1)
         for k in range(2 * n_taps + 1)], axis=1)            # (n_ch, n_tap, n)
    return _corr_taps(taps, mixed)


def _discriminators(corr_i: jax.Array, corr_q: jax.Array, state: TrackState,
                    n_taps: int, dt: float):
    """PLL (Costas atan), FLL (cross/dot), DLL (E-L envelope) errors.

    Mirrors pll/dll of sdrtrk.c:66-109: atan discriminator for carrier
    (data-bit insensitive), early-late envelope for code.
    """
    ip = corr_i[:, n_taps]
    qp = corr_q[:, n_taps]
    # PLL: Costas atan(Q/I) [rad]
    perr = jnp.arctan2(qp * jnp.sign(ip), jnp.abs(ip))
    # FLL: frequency error from successive prompts [Hz]. The
    # cross*sign(dot) form is invariant under a data-symbol flip between
    # the prompts (a flip negates BOTH cross and dot): without it, the
    # measured error flips sign on every symbol transition, which for
    # Galileo E1B (one symbol per epoch, p=0.5 flips) zeroes the
    # deterministic pull and turns the FLL into a pure noise random walk
    # onto the +/-k*125 Hz Costas lattice. Range +/-1/(4*dt).
    cross = state.ip_prev * qp - state.qp_prev * ip
    dot = state.ip_prev * ip + state.qp_prev * qp
    dsign = jnp.where(dot >= 0.0, 1.0, -1.0)
    ferr = jnp.arctan2(cross * dsign, jnp.abs(dot) + 1e-12) \
        / (2.0 * jnp.pi * dt)
    # DLL: innermost early/late envelope pair
    ie, qe = corr_i[:, n_taps - 1], corr_q[:, n_taps - 1]
    il, ql = corr_i[:, n_taps + 1], corr_q[:, n_taps + 1]
    e_env = jnp.sqrt(ie * ie + qe * qe)
    l_env = jnp.sqrt(il * il + ql * ql)
    derr = (e_env - l_env) / jnp.maximum(e_env + l_env, 1e-12) / 2.0
    return perr, ferr, derr, ip, qp


def make_tracker(code_table: np.ndarray, sample_rate: float,
                 cfg: TrackingConfig,
                 code_len: int = C.GPS_CA_CODE_LEN,
                 chip_rate: float = C.GPS_CA_CHIP_RATE_HZ,
                 carrier_hz=C.GPS_L1_FREQ_HZ,
                 epoch_ms: float = 1.0,
                 nominal_offset_hz=0.0):
    """Build the jittable multi-channel tracking step + scan runner.

    code_table: (n_ch, code_len) host numpy +/-1 chips for the tracked PRNs.
    carrier_hz / nominal_offset_hz: scalar or per-channel (n_ch,) — FDMA
    constellations track carr_freq = channel offset + Doppler, and the
    carrier-aided code NCO must scale only the Doppler part by
    chip_rate/carrier (sdrtrk.c:105-107 with the sdrinit.c:391-399 mapping).
    Returns (step, run) where
      step(state, x_window: CArray (n,)) -> (state', TrackOutputs-per-epoch)
      run(state, x: CArray (n_epochs*n,)) -> (state', TrackOutputs stacked)

    `run` additionally accepts (table_arg, carrier_arg, offset_arg) as
    TRACED overrides of the build-time constants (which then only fix
    shapes) — one compiled executable serves any channel-to-slot
    assignment, the property the streaming receiver's re-acquisition /
    health-reset cycle needs (sdrmain.c:248-400 resetStructs role).
    """
    dt = epoch_ms * 1e-3
    n_epoch = int(round(sample_rate * dt))
    table = jnp.asarray(code_table, jnp.float32)
    n_ch_static = code_table.shape[0]
    # shift-based fast correlator: usable when one code period is an
    # integer number of samples (true for all supported front-ends:
    # 2048 @ 2.048 MS/s GPS, 16384 @ 4.096 MS/s E1B, 10000 @ 10 MS/s G1)
    cps0 = chip_rate / sample_rate
    period_f = code_len / cps0
    n_period = int(round(period_f))
    margin = cfg.n_taps * cfg.tap_spacing_samples
    use_base = abs(period_f - n_period) < 1e-6 and n_period == n_epoch
    base3 = (jnp.asarray(resample_base_table(
        np.asarray(code_table, np.float32), cps0, n_period, margin))
        if use_base else None)
    carrier_v = jnp.broadcast_to(
        jnp.asarray(carrier_hz, jnp.float32), (n_ch_static,))
    offset_v = jnp.broadcast_to(
        jnp.asarray(nominal_offset_hz, jnp.float32), (n_ch_static,))
    n_taps = cfg.n_taps
    # tap index used for the noise floor: the outermost early tap sits
    # n_taps*spacing samples (~2 chips at 2 taps/chip) off prompt.
    # loop gain 1.0: the atan discriminators have unit slope, and the
    # discrete-time stability bound c1*2*pi*dt < 2 requires it at these
    # bandwidths (gain k scales c1 = 2*damping*wn/k).
    # The configured bandwidths assume 1 ms epochs (sdrinit.c:27-32);
    # since c1 = 2*damping*(bw/0.53) is dt-independent, a longer coherent
    # epoch (Galileo's 4 ms) can push 2*pi*c1*dt past 2 and the phase
    # loop period-2 diverges. Clamp the effective bandwidth so the
    # proportional gain stays at <= 0.5 of the stability bound — the
    # discrete-time analogue of "B*T must stay small" (Kaplan 5.5).
    bw_max = 0.5 / (2.0 * np.pi * (2.0 * cfg.damping / 0.53) * dt)
    c1p_pull, c2p_pull = loop_coeffs(min(cfg.pll_bw_pullin_hz, bw_max),
                                     cfg.damping, dt)
    c1p_lock, c2p_lock = loop_coeffs(min(cfg.pll_bw_locked_hz, bw_max),
                                     cfg.damping, dt)
    c1d_pull, c2d_pull = loop_coeffs(min(cfg.dll_bw_pullin_hz, bw_max),
                                     cfg.damping, dt)
    c1d_lock, c2d_lock = loop_coeffs(min(cfg.dll_bw_locked_hz, bw_max),
                                     cfg.damping, dt)
    # staged pull-in: a 1st-order FLL alone closes the coarse (200 Hz
    # acquisition bin) frequency error, then the PLL takes over — running
    # both discriminators into one NCO simultaneously is the classic
    # instability; the reference stages via its prm1/prm2 switch too.
    kf = 4.0 * cfg.fll_bw_pullin_hz * dt * 0.25
    fll_epochs = int(cfg.pullin_ms / epoch_ms) // 4
    pullin_epochs = int(cfg.pullin_ms / epoch_ms)
    ema = 1.0 / max(cfg.snr_smooth_ms / epoch_ms, 1.0)

    def step_with(state: TrackState, inputs, tab, carr, offs_hz,
                  base_tab=None):
        x, epoch_idx = inputs
        fll_stage = epoch_idx < fll_epochs
        locked = epoch_idx >= pullin_epochs
        if base_tab is not None:
            corr_i, corr_q = _tap_correlate_base(
                x, base_tab, state, n_taps, cfg.tap_spacing_samples,
                sample_rate, chip_rate, n_period)
        else:
            corr_i, corr_q = _tap_correlate(
                x, tab, state, n_taps, cfg.tap_spacing_samples, sample_rate,
                code_len)
        perr, ferr, derr, ip, qp = _discriminators(corr_i, corr_q, state,
                                                   n_taps, dt)
        c1p = jnp.where(locked, c1p_lock, c1p_pull)
        c2p = jnp.where(locked, c2p_lock, c2p_pull)
        c1d = jnp.where(locked, c1d_lock, c1d_pull)
        c2d = jnp.where(locked, c2d_lock, c2d_pull)

        carr_freq = jnp.where(
            fll_stage,
            state.carr_freq_hz + kf * ferr,
            state.carr_freq_hz
            + c1p * (perr - state.perr_prev) + c2p * perr)
        # carrier-aided code NCO (sdrtrk.c:105-107) minus the accumulated
        # DLL correction (SoftGNSS codeNco form)
        code_nco = (state.code_nco_hz
                    + c1d * (derr - state.derr_prev) + c2d * derr)
        code_freq = chip_rate * (1.0 + (carr_freq - offs_hz) / carr) \
            - code_nco

        # advance NCO phases over the epoch
        carr_phase = (state.carr_phase_rad
                      + 2.0 * jnp.pi * state.carr_freq_hz * dt)
        carr_phase = jnp.mod(carr_phase, 2.0 * jnp.pi)
        code_rem = jnp.mod(state.code_rem_chips
                           + state.code_freq_hz / sample_rate * n_epoch,
                           float(code_len))

        # C/N0: prompt power vs outermost-tap power, EMA-smoothed
        p_sig = ip * ip + qp * qp
        p_noise = corr_i[:, 0] ** 2 + corr_q[:, 0] ** 2
        sig_ema = state.sig_ema + ema * (p_sig - state.sig_ema)
        noise_ema = state.noise_ema + ema * (p_noise - state.noise_ema)
        snr_lin = jnp.maximum(sig_ema - noise_ema, 1e-12) / \
            jnp.maximum(noise_ema, 1e-12)
        cn0 = 10.0 * jnp.log10(snr_lin / dt)

        new = TrackState(
            carr_freq_hz=carr_freq, carr_phase_rad=carr_phase,
            code_freq_hz=code_freq, code_nco_hz=code_nco,
            code_rem_chips=code_rem,
            perr_prev=perr, derr_prev=derr, ip_prev=ip, qp_prev=qp,
            noise_ema=noise_ema, sig_ema=sig_ema)
        out = TrackOutputs(
            i_prompt=ip, q_prompt=qp, carr_freq_hz=carr_freq,
            code_freq_hz=code_freq, code_rem_chips=state.code_rem_chips,
            carr_phase_rad=state.carr_phase_rad, cn0_dbhz=cn0,
            perr=perr, derr=derr)
        return new, out

    def step(state: TrackState, inputs):
        return step_with(state, inputs, table, carrier_v, offset_v,
                         base_tab=base3)

    def run(state: TrackState, x: cplx.CArray, start_epoch: int = 0,
            start_offsets=None, table_arg=None, carrier_arg=None,
            offset_arg=None, n_epochs: int | None = None):
        """Scan the tracker over a capture.

        start_offsets: optional (n_ch,) int per-channel window start
        samples. With offsets, channel c's epoch-k window is
        x[off_c + k*n_epoch : ...] — gathered per step with
        dynamic_slice so the capture stays resident once. Aligning
        offsets to each channel's acquired code boundary keeps data-
        symbol edges OUT of the correlation windows, which is essential
        when the symbol period equals the epoch (Galileo E1B: one 250 sps
        symbol per 4 ms code period — a mid-window flip cancels the
        prompt; the reference gets alignment for free from its
        variable-length per-channel grabs, sdrtrk.c:16-18).

        table_arg/carrier_arg/offset_arg (dynamic_channels mode): traced
        overrides of the build-time constants; start_epoch and
        start_offsets may then also be traced.
        """
        tab = table if table_arg is None else table_arg
        carr = carrier_v if carrier_arg is None else carrier_arg
        offs_hz = offset_v if offset_arg is None else offset_arg
        if not use_base:
            base = None
        elif table_arg is None:
            base = base3
        else:
            # one device-side resample per run (outside the scan), so the
            # dynamic-channel executable keeps the fast correlator
            base = resample_base_table_jnp(tab, cps0, n_period, margin)

        def stp(st, inp):
            return step_with(st, inp, tab, carr, offs_hz, base_tab=base)

        if start_offsets is None:
            n_ep = x.shape[-1] // n_epoch if n_epochs is None else n_epochs
            windows = cplx.apply(
                lambda a: a[..., : n_ep * n_epoch]
                .reshape(n_ep, n_epoch), x)
            idx = jnp.arange(n_ep) + start_epoch
            return jax.lax.scan(stp, state, (windows, idx))

        offs = jnp.asarray(start_offsets, jnp.int32)
        if n_epochs is None:
            n_epochs = int((x.shape[-1] - int(np.max(start_offsets)))
                           // n_epoch)

        # chunked window gather: gather K epochs per slot in one
        # contiguous slice per outer step, then feed the K per-epoch
        # windows to the inner scan as xs (leading-axis scan slices are
        # free) — identical windows, K-fold fewer gathers than a per-epoch
        # vmapped dynamic_slice (an earlier-accelerator choice, where
        # gathers serialized; not measured on H100).
        K = 1
        for cand in range(min(16, n_epochs), 0, -1):
            if n_epochs % cand == 0:
                K = cand
                break
        n_ch = offs.shape[0]

        def chunk_step(st, c):
            starts = offs + c * (K * n_epoch)
            seg = cplx.apply(
                lambda a: jax.vmap(
                    lambda s: jax.lax.dynamic_slice(a, (s,),
                                                    (K * n_epoch,))
                )(starts), x)                        # (n_ch, K*n_epoch)
            wins = cplx.apply(
                lambda a: jnp.swapaxes(
                    a.reshape(n_ch, K, n_epoch), 0, 1), seg)
            # start_epoch may be per-channel (the streaming receiver's
            # slot ages) — each inner-scan element gets its (n_ch,) row
            idx = ((c * K + jnp.arange(K))[:, None]
                   + jnp.atleast_1d(jnp.asarray(start_epoch))[None, :])
            return jax.lax.scan(stp, st, (wins, idx))

        st2, outs = jax.lax.scan(chunk_step, state,
                                 jnp.arange(n_epochs // K))
        outs = jax.tree_util.tree_map(
            lambda a: a.reshape((n_epochs,) + a.shape[2:]), outs)
        return st2, outs

    return step, run, n_epoch
