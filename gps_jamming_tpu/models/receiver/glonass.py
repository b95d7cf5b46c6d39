"""GLONASS L1OF support: FDMA acquisition, GNAV string encode/decode.

Re-design of the reference's GLONASS path: the FDMA carrier mapping of
`initsdrch` (k = prn - 8, sdrinit.c:391-399), the 511-chip acquisition
(sdracq.c at 10 MS/s), and the string decoder `sdrnav_glo.c:26-229`
(time-mark sync, meander removal, per-string KX Hamming, pos/vel/acc
ephemeris from strings 1-4).

Acquisition is one batched CAF: the 14 FDMA channels' carrier offsets and
the Doppler grid flatten into a single frequency axis, so every channel x
Doppler x lag is evaluated in one kernel call against the single shared
511-chip replica.

GNAV timing: 100 sps line symbols = 50 bps data x 100 Hz meander; each
2 s string = 1.7 s (170 symbols) of data + 0.3 s time mark (30 symbols).
The KX check is the ICD's modified Hamming over bit positions 1..85
(check bits at positions 1..8; group i covers data positions whose binary
code has bit i-1 set; bit 8 is overall parity).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ...config import AcquisitionConfig
from ...ops import caf as caf_ops
from ...ops import codes as codes_ops
from ...ops import corr as corr_ops
from ...ops import cplx
from ...utils import constants as C
from . import acquisition as acq_mod

# 14 channels as in the reference (sdrinit.c:41-107): freq numbers -7..+6
FREQ_CHANNELS = tuple(range(-7, 7))
STRING_SECONDS = 2.0
DATA_SYMBOLS = 170            # 1.7 s at 100 sps
MARK_SYMBOLS = 30
# 30-symbol time mark (ICD: 111110001101110101000010010110)
TIME_MARK = np.array([1, 1, 1, 1, 1, 0, 0, 0, 1, 1, 0, 1, 1, 1, 0, 1, 0,
                      1, 0, 0, 0, 0, 1, 0, 0, 1, 0, 1, 1, 0], np.int64)


def channel_offsets_hz(center_freq_hz: float = C.GLO_G1_BASE_FREQ_HZ,
                       channels=FREQ_CHANNELS) -> np.ndarray:
    """Baseband carrier offset of each FDMA channel after mix-down by the
    front-end centre frequency (sdrinit.c:391-399)."""
    return np.array([C.GLO_G1_BASE_FREQ_HZ + k * C.GLO_G1_CH_SPACING_HZ
                     - center_freq_hz for k in channels], np.float64)


def replica_table_host(sample_rate: float, n_samples: int):
    """conj(FFT) of the shared 511-chip code at the capture rate."""
    re, im = codes_ops.sampled_code_fft_conj_host(
        codes_ops.glonass_code()[None, :], C.GLO_CHIP_RATE_HZ, sample_rate,
        n_samples)
    return cplx.CArray(re, im)


def acquire_all(blocks, sample_rate: float, cfg: AcquisitionConfig,
                center_freq_hz: float = C.GLO_G1_BASE_FREQ_HZ,
                channels=FREQ_CHANNELS, method: str = "auto"):
    """Batched acquisition over (FDMA channel x Doppler x lag).

    method: 'pcf' (default via 'auto' when the block count splits into
    coherent groups) = the factorized sub-bin-mix + replica-shift search;
    'std' = the direct per-(channel x Doppler)-row search.

    blocks: (n_intg, n) complex/CArray baseband at `sample_rate` centred
    on `center_freq_hz`. Returns an AcquisitionResult whose leading axis is
    the FDMA channel list, with doppler_hz relative to each channel's
    carrier (the FDMA offset already removed).

    Near-far caveat: all FDMA channels share one ranging code, separated
    only by carrier. A channel carrying a signal far above the noise floor
    (unphysical for satellites, possible for a spoofer) leaks its
    rectangular-chip spectral sidelobes into other channels' bands and can
    trip their peak-ratio test; such ghosts surface at implausible C/N0 /
    grid-edge Doppler and die in tracking (the reference's health resets,
    sdrmain.c:263-340, play the same cleanup role).
    """
    blocks = cplx.asarray(blocks)
    n = blocks.shape[-1]
    nb = blocks.shape[-2]
    offsets = channel_offsets_hz(center_freq_hz, channels)
    rep = replica_table_host(sample_rate, n)
    n_groups = 2
    if method == "auto":
        # the PCF grid's worst-case interior spacing is ~100 Hz (500 Hz
        # sets + {-200,0,200} fine); a finer configured step means the
        # caller wants the explicit grid — honor it via the direct path
        method = ("pcf" if nb % n_groups == 0
                  and cfg.doppler_step_hz >= 100.0 else "std")
    if method == "pcf":
        # factorized search (ops.caf.caf_accumulate_pcf_fdma): mixes only
        # (channel-sub-bin x set) rows instead of all 14x71 frequency
        # rows — the direct form's (B, 994, n) complex intermediates are
        # gigabytes at 10 MS/s (speed not measured on H100);
        # 5 ms coherent groups beat the reference's 10x1 ms non-coherent
        # sensitivity (sdracq.c:15-27) on a finer effective grid.
        surf = caf_ops.caf_accumulate_pcf_fdma(
            blocks, rep, offsets, sample_rate,
            max_doppler_hz=cfg.doppler_max_hz, n_groups=n_groups)
        freqs = jnp.asarray(caf_ops.pcf_doppler_hz(
            sample_rate, n, cfg.doppler_max_hz))
        gl = nb // n_groups
        res = acq_mod.acquisition_test(surf, freqs, sample_rate, cfg,
                                       code_period_s=1e-3 * max(gl, 1),
                                       code_len_chips=511.0)
        return _nearfar_veto(res, n)
    dopp = caf_ops.doppler_bins(cfg.doppler_max_hz, cfg.doppler_step_hz)
    # flatten (channel, doppler) into one frequency axis
    freqs = (offsets[:, None] + dopp[None, :]).astype(np.float32).ravel()
    surf = caf_ops.caf_surface(blocks, rep, jnp.asarray(freqs), sample_rate)
    # (n_intg, 1, n_ch*n_dopp, n) -> sum integrations -> (n_ch, n_dopp, n)
    surf = jnp.sum(surf, axis=0)[0].reshape(len(channels), dopp.size, n)
    res = acq_mod.acquisition_test(surf, jnp.asarray(dopp), sample_rate,
                                   cfg, code_period_s=1e-3,
                                   code_len_chips=511.0)
    return _nearfar_veto(res, n)


def _nearfar_veto(res, n: int, dominance: float = 100.0,
                  lag_chips: float = 6.0):
    """Suppress FDMA near-far ghosts (traced; safe under jit).

    All GLONASS channels share ONE ranging code, so a strong channel's
    spectral sidelobes leak a lag-aligned correlation peak into other
    channels' bands (the acquire_all docstring caveat). A channel whose
    peak power is `dominance`x below an acquired channel at (circularly)
    the same code lag is that channel's leakage image, not a satellite —
    real GLONASS near-far never reaches 20 dB (satellite geometry bounds
    the received-power spread). The reference cleans such ghosts up via
    tracking health resets (sdrmain.c:263-340); vetoing them at
    acquisition keeps them from occupying receiver slots at all.
    """
    lag_samps = lag_chips * n / 511.0
    acq = res.acquired
    peak = res.peak_power
    lag = res.code_phase.astype(jnp.float32)
    d = jnp.abs(lag[:, None] - lag[None, :])
    circ = jnp.minimum(d, n - d)
    dominated = (acq[None, :]
                 & (peak[None, :] > peak[:, None] * dominance)
                 & (circ < lag_samps))
    veto = jnp.any(dominated, axis=1)
    return res._replace(acquired=acq & ~veto)


# ---------------------------------------------------------------------------
# GNAV string encode/decode (host numpy)
# ---------------------------------------------------------------------------

def _kx_groups():
    """Data-bit positions (9..85) covered by each of C1..C7."""
    groups = []
    for i in range(7):
        groups.append([p for p in range(9, 86) if (p >> i) & 1])
    return groups


_KX = _kx_groups()


def kx_checksum(data77: np.ndarray) -> np.ndarray:
    """8 check bits for the 77 data bits (positions 9..85, MSB=85 first in
    transmit order; here data77[0] = position 85 ... data77[76] = 9)."""
    bit_at = {85 - i: int(b) for i, b in enumerate(np.asarray(data77) & 1)}
    c = np.zeros(8, np.int64)
    for i in range(7):
        c[i] = np.bitwise_xor.reduce([bit_at[p] for p in _KX[i]])
    c[7] = (np.bitwise_xor.reduce([bit_at[p] for p in range(9, 86)])
            ^ np.bitwise_xor.reduce(c[:7]))
    return c


def encode_string(data77: np.ndarray) -> np.ndarray:
    """85-bit string in transmit order: data (pos 85..9) + KX (pos 8..1)."""
    data77 = np.asarray(data77, np.int64) & 1
    c = kx_checksum(data77)
    return np.concatenate([data77, c[::-1]])


def check_string(bits85: np.ndarray):
    """KX verify; returns (ok, data77)."""
    bits85 = np.asarray(bits85, np.int64) & 1
    data77 = bits85[:77]
    ok = bool(np.array_equal(encode_string(data77), bits85))
    return ok, data77


@dataclasses.dataclass
class GloEphemeris:
    """GLONASS broadcast state (strings 1-4) in PZ-90 ECEF, SI units."""
    freq_ch: int = 0
    tb_s: float = 0.0            # frame time within day
    tk_s: float = 0.0
    pos_m: tuple = (0.0, 0.0, 0.0)
    vel_mps: tuple = (0.0, 0.0, 0.0)
    acc_mps2: tuple = (0.0, 0.0, 0.0)
    tau_s: float = 0.0           # SV clock bias
    gamma: float = 0.0           # relative freq bias
    have_strings: tuple = ()

    @property
    def complete(self) -> bool:
        return {1, 2, 3, 4} <= set(self.have_strings)


def _sgn_mag(bits: np.ndarray, scale: float) -> float:
    """GLONASS sign-magnitude field: MSB = sign."""
    mag = 0
    for b in bits[1:]:
        mag = (mag << 1) | int(b)
    return (-mag if bits[0] else mag) * scale


def _pack_sgn_mag(value: float, width: int, scale: float) -> np.ndarray:
    mag = int(round(abs(value) / scale))
    out = np.zeros(width, np.int64)
    out[0] = 1 if value < 0 else 0
    for i in range(width - 1):
        out[width - 1 - i] = (mag >> i) & 1
    return out


def _pack_u(value: int, width: int) -> np.ndarray:
    return np.array([(int(value) >> (width - 1 - i)) & 1
                     for i in range(width)], np.int64)


def _u(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


# String layout within the 77 data bits (index 0 = position 85 =
# transmit-first). Field WIDTHS and SCALES follow the GLONASS ICD /
# sdrnav_glo.c:26-199 (coords 2^-11 km sign-magnitude 27 bits, vel 2^-20
# km/s 24 bits, acc 2^-30 km/s^2 5 bits, tb 15-min units 7 bits, tk
# 5 h + 6 min + 1 half-minute bits, tau 2^-30 s 22 bits, gamma 2^-40
# 11 bits); field POSITIONS are framework-canonical (the simulator and
# decoder share them; over-the-air ICD bit positions can be swapped in
# without touching the field math):
#   all strings: d[0:4] = string number m
#   m=1..3: vel d[9:33], acc d[33:38], pos d[38:65]  (x/y/z for m=1/2/3)
#   m=1 adds tk seconds (17 bits: high d[4:9], low d[65:77]);
#   m=2 adds tb d[65:72]
#   m=4: tau d[4:26], gamma d[26:37]

_POS_SCALE = 2.0 ** -11 * 1e3
_VEL_SCALE = 2.0 ** -20 * 1e3
_ACC_SCALE = 2.0 ** -30 * 1e3


def encode_eph_strings(eph: GloEphemeris) -> list[np.ndarray]:
    """Strings 1-4 (85 bits each, transmit order) for the simulator."""
    out = []
    for m in (1, 2, 3, 4):
        d = np.zeros(77, np.int64)
        d[0:4] = _pack_u(m, 4)
        i = m - 1
        if m <= 3:
            d[9:33] = _pack_sgn_mag(eph.vel_mps[i], 24, _VEL_SCALE)
            d[33:38] = _pack_sgn_mag(eph.acc_mps2[i], 5, _ACC_SCALE)
            d[38:65] = _pack_sgn_mag(eph.pos_m[i], 27, _POS_SCALE)
        if m == 1:
            # framework-canonical tk: 17 bits of whole seconds split across
            # the spare d[4:9] (high) + d[65:77] (low) fields — the ICD's
            # 30 s hh/mm/half-min tk cannot timestamp our 2 s string
            # cadence (real GLONASS anchors strings within 30 s frames;
            # the field MATH is unchanged, only the packing is canonical)
            tk = int(round(eph.tk_s)) & 0x1FFFF
            d[4:9] = _pack_u(tk >> 12, 5)
            d[65:77] = _pack_u(tk & 0xFFF, 12)
        if m == 2:
            d[65:72] = _pack_u(int(eph.tb_s // 900), 7)
        if m == 4:
            d[4:26] = _pack_sgn_mag(eph.tau_s, 22, 2.0 ** -30)
            d[26:37] = _pack_sgn_mag(eph.gamma, 11, 2.0 ** -40)
        out.append(encode_string(d))
    return out


def decode_strings(strings: list[np.ndarray],
                   freq_ch: int = 0) -> GloEphemeris:
    """Decode KX-verified strings 1-4 into a GloEphemeris."""
    eph = GloEphemeris(freq_ch=freq_ch)
    have = []
    pos = [0.0, 0.0, 0.0]
    vel = [0.0, 0.0, 0.0]
    acc = [0.0, 0.0, 0.0]
    for s in strings:
        ok, d = check_string(s)
        if not ok:
            continue
        m = _u(d[0:4])
        if m < 1 or m > 4:
            continue
        if m <= 3:
            vel[m - 1] = _sgn_mag(d[9:33], _VEL_SCALE)
            acc[m - 1] = _sgn_mag(d[33:38], _ACC_SCALE)
            pos[m - 1] = _sgn_mag(d[38:65], _POS_SCALE)
        if m == 1:
            eph.tk_s = float((_u(d[4:9]) << 12) | _u(d[65:77]))
        if m == 2:
            eph.tb_s = _u(d[65:72]) * 900.0
        if m == 4:
            eph.tau_s = _sgn_mag(d[4:26], 2.0 ** -30)
            eph.gamma = _sgn_mag(d[26:37], 2.0 ** -40)
        if m not in have:
            have.append(m)
    eph.pos_m = tuple(pos)
    eph.vel_mps = tuple(vel)
    eph.acc_mps2 = tuple(acc)
    eph.have_strings = tuple(sorted(have))
    return eph


def symbols_to_strings_pos(symbols01: np.ndarray,
                           max_mark_errors: int = 1
                           ) -> list[tuple[int, np.ndarray]]:
    """Line symbols (100 sps, 0/1 hard decisions) -> [(time-mark start
    index, 85-bit string)].

    Time-mark correlation locates string boundaries (sdrnav_glo.c time
    mark search, both polarities, up to `max_mark_errors` symbol errors —
    the KX check is the real validator); each following 170 data symbols
    de-meander (pairs [d, ~d]) into 85 bits.
    """
    sym = np.asarray(symbols01, np.int64) & 1
    n = sym.size
    mark = TIME_MARK
    out = []
    for start in range(0, n - (MARK_SYMBOLS + DATA_SYMBOLS) + 1):
        w = sym[start:start + MARK_SYMBOLS]
        d_pos = int(np.sum(w ^ mark))
        d_neg = MARK_SYMBOLS - d_pos
        if min(d_pos, d_neg) > max_mark_errors:
            continue
        flip = 1 if d_neg < d_pos else 0
        data = sym[start + MARK_SYMBOLS:
                   start + MARK_SYMBOLS + DATA_SYMBOLS] ^ flip
        pairs = data.reshape(85, 2)
        # meander: symbol pair (b, ~b) encodes bit b; tolerate a few
        # broken pairs as long as the KX check of the result passes
        if int(np.sum(pairs[:, 0] ^ pairs[:, 1] != 1)) > 4:
            continue
        bits = pairs[:, 0]
        if check_string(bits)[0]:
            out.append((start, bits))
    return out


def symbols_to_strings(symbols01: np.ndarray):
    """KX-checked strings without positions (compatibility form)."""
    return [s for _, s in symbols_to_strings_pos(symbols01)]


STRING_SYMBOLS = MARK_SYMBOLS + DATA_SYMBOLS     # 200 symbols = 2 s
SYMBOL_RATE_SPS = 100.0
CYCLE_STRINGS = (1, 2, 3, 4)


def encode_gnav_stream(eph: GloEphemeris, start_tk_s: float,
                       n_cycles: int) -> np.ndarray:
    """Continuous GNAV line-symbol stream with live timing.

    Cycle c (8 s) sends strings 1-4; string m starts at
    start_tk_s + 8c + 2(m-1), and each cycle's string 1 carries
    tk = its OWN time-mark start second — the anchor contract
    decode_gnav_stream recovers.
    """
    import copy
    out = []
    for c in range(n_cycles):
        e = copy.copy(eph)
        e.tk_s = start_tk_s + 8.0 * c
        out.append(bits_to_symbols(encode_eph_strings(e)))
    return np.concatenate(out)


def decode_gnav_stream(symbols01: np.ndarray, freq_ch: int = 0
                       ) -> tuple[GloEphemeris, list[tuple[int, float]]]:
    """Symbol stream -> (GloEphemeris, anchors).

    anchors: (symbol index of a string-1 time-mark start, tk_s at that
    edge) — the GLONASS transmit-time anchors (sdrnav_glo.c role).
    """
    found = symbols_to_strings_pos(symbols01)
    eph = decode_strings([s for _, s in found], freq_ch=freq_ch)
    anchors = []
    for pos, s in found:
        ok, d = check_string(s)
        if ok and _u(d[0:4]) == 1:
            tk = float((_u(d[4:9]) << 12) | _u(d[65:77]))
            anchors.append((pos, tk))
    return eph, anchors


def bits_to_symbols(strings: list[np.ndarray]) -> np.ndarray:
    """Simulator side: strings -> line symbols with meander + time marks."""
    out = []
    for s in strings:
        pairs = np.stack([s, s ^ 1], axis=1).reshape(-1)
        out.append(np.concatenate([TIME_MARK, pairs]))
    return np.concatenate(out)
