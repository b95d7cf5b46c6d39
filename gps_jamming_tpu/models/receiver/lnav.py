"""GPS LNAV message: parity, frame encode (sim fixtures) and decode.

Host-side numpy bit plumbing — SURVEY.md §7 keeps bit-level nav decode off
the accelerator (hostile op mix); only the soft bit values come from the device
(prompt-I signs out of the tracking scan).

Covers the reference's C8/C9 components:
- (32,26) Hamming parity of IS-GPS-200 20.3.5 — checker equivalent to
  `paritycheck_l1ca` (sdrnav_gps.c:102-131) plus the encoder the reference
  lacks (its fixtures come from gps-sdr-sim; ours are self-generated).
- preamble search over the bit ring (findpreamble, sdrnav.c:284-328),
- subframe 1-3 field extraction -> ephemeris (decode_frame_l1ca,
  sdrnav_gps.c:3-100) with the ICD scale factors.

Bit conventions: bits are numpy int arrays of 0/1. A word is 30 bits:
24 data + 6 parity. `d29`/`d30` are the last two parity bits of the
previous word.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

PREAMBLE = np.array([1, 0, 0, 0, 1, 0, 1, 1], dtype=np.int64)
WORD_BITS = 30
SUBFRAME_BITS = 300
SUBFRAME_SECONDS = 6.0
BIT_MS = 20

# IS-GPS-200 table 20-XIV: data-bit indices (1-based d1..d24) feeding each
# parity bit D25..D30.
_PARITY_TAPS = (
    (1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23),          # D25
    (2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24),          # D26
    (1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22),           # D27
    (2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23),           # D28
    (1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24),       # D29
    (3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24),              # D30
)
# which of D29*/D30* seeds each parity bit (index 0 = D29*, 1 = D30*)
_PARITY_SEED = (0, 1, 0, 1, 1, 0)


def encode_word(data24: np.ndarray, d29: int, d30: int) -> np.ndarray:
    """Encode one 30-bit word: complement data by D30*, append parity.

    data24: (24,) source data bits (pre-complement, as held in registers).
    Returns (30,) transmitted bits.
    """
    data24 = np.asarray(data24, dtype=np.int64) & 1
    tx_data = data24 ^ d30
    seeds = (d29, d30)
    parity = np.empty(6, dtype=np.int64)
    for k, taps in enumerate(_PARITY_TAPS):
        p = seeds[_PARITY_SEED[k]]
        for t in taps:
            p ^= data24[t - 1]
        parity[k] = p
    return np.concatenate([tx_data, parity])


def check_word(word30: np.ndarray, d29: int, d30: int):
    """Parity-check one received word.

    Returns (ok, data24) where data24 are the decoded (de-complemented)
    source bits — the contract of paritycheck_l1ca (sdrnav_gps.c:102-131).
    """
    word30 = np.asarray(word30, dtype=np.int64) & 1
    data = word30[:24] ^ d30
    expect = encode_word(data, d29, d30)
    return bool(np.array_equal(expect, word30)), data


def encode_subframe(data_words: np.ndarray, d29: int = 0,
                    d30: int = 0) -> np.ndarray:
    """Encode 10 x 24 data bits into a 300-bit subframe with chained parity.

    The t-bits of HOW (word 2) are NOT solved for here — callers must leave
    bits 23-24 of word 2 zero and accept the resulting parity (gps-sdr-sim
    solves them so D29/D30 of HOW end 00; for fixture purposes chained
    parity is sufficient since the decoder keeps per-word D29*/D30*).
    """
    out = np.empty(SUBFRAME_BITS, dtype=np.int64)
    for w in range(10):
        word = encode_word(data_words[w], d29, d30)
        out[w * 30:(w + 1) * 30] = word
        d29, d30 = int(word[28]), int(word[29])
    return out


def check_subframe(bits300: np.ndarray, d29: int, d30: int):
    """Parity-check 10 chained words; returns (ok, (10,24) data bits)."""
    bits300 = np.asarray(bits300, dtype=np.int64) & 1
    data = np.empty((10, 24), dtype=np.int64)
    for w in range(10):
        word = bits300[w * 30:(w + 1) * 30]
        ok, d = check_word(word, d29, d30)
        if not ok:
            return False, None
        data[w] = d
        d29, d30 = int(word[28]), int(word[29])
    return True, data


# ---------------------------------------------------------------------------
# bit-field packing helpers (getbitu/getbits of rtkcmn.c:84-? equivalents,
# operating on 0/1 arrays rather than byte buffers)
# ---------------------------------------------------------------------------

def pack_bits(value: int, width: int) -> np.ndarray:
    """Unsigned value -> MSB-first bit array of `width`."""
    value = int(value) & ((1 << width) - 1)
    return np.array([(value >> (width - 1 - i)) & 1 for i in range(width)],
                    dtype=np.int64)


def unpack_u(bits: np.ndarray) -> int:
    """MSB-first bit array -> unsigned int."""
    v = 0
    for b in np.asarray(bits, dtype=np.int64):
        v = (v << 1) | int(b)
    return v


def unpack_s(bits: np.ndarray) -> int:
    """MSB-first bit array -> two's-complement signed int."""
    v = unpack_u(bits)
    w = len(bits)
    if v >= (1 << (w - 1)):
        v -= 1 << w
    return v


@dataclasses.dataclass
class Ephemeris:
    """GPS LNAV ephemeris + clock (subframes 1-3), SI units / semicircles
    already converted to radians. Mirrors the eph fields the reference
    decodes in sdrnav_gps.c:3-100 and consumes in satPos (sdrpvt.c:440-537).
    """
    prn: int = 0
    week: int = 0
    # clock (subframe 1)
    toc: float = 0.0
    af0: float = 0.0
    af1: float = 0.0
    af2: float = 0.0
    tgd: float = 0.0
    iodc: int = 0
    ura: int = 0
    health: int = 0
    # orbit (subframes 2-3)
    iode: int = 0
    toe: float = 0.0
    sqrt_a: float = 0.0
    e: float = 0.0
    m0: float = 0.0
    delta_n: float = 0.0
    omega0: float = 0.0
    omega_dot: float = 0.0
    omega: float = 0.0
    i0: float = 0.0
    idot: float = 0.0
    cuc: float = 0.0
    cus: float = 0.0
    crc: float = 0.0
    crs: float = 0.0
    cic: float = 0.0
    cis: float = 0.0
    # decode bookkeeping
    tow_s: float = 0.0
    have_subframes: tuple = ()
    # broadcast UTC conversion parameters (GPS LNAV subframe 4 page 18 /
    # Galileo I/NAV word 6) — None until the UTC word is decoded
    utc: "UtcParams | None" = None
    # Klobuchar ionosphere coefficients (subframe 4 page 18)
    iono: "IonoParams | None" = None
    # almanac entries keyed by PRN (subframe 5 pages 1-24)
    almanac: dict = dataclasses.field(default_factory=dict)

    @property
    def complete(self) -> bool:
        return {1, 2, 3} <= set(self.have_subframes)


class UtcParams(NamedTuple):
    """Broadcast (GPS or GST)->UTC conversion parameters.

    Same parameter set in IS-GPS-200 (subframe 4 page 18) and the Galileo
    OS SIS ICD 5.1.7 (I/NAV word 6, GST-UTC): first-order polynomial
    (a0, a1) about reference (t0t, wn0t), current leap seconds dt_ls and a
    scheduled leap (wn_lsf, dn, dt_lsf)."""
    a0: float = 0.0            # s
    a1: float = 0.0            # s/s
    dt_ls: int = 0             # current leap seconds
    t0t: float = 0.0           # reference time of week [s]
    wn0t: int = 0              # reference week (mod 256 / GST mod 4096)
    wn_lsf: int = 0            # week of scheduled leap
    dn: int = 0                # day of scheduled leap (1..7)
    dt_lsf: int = 0            # leap seconds after the event

    def to_utc_seconds(self, tow_s: float, week: int) -> float:
        """System time (tow within week) -> UTC seconds-of-week, the
        ICD 5.1.7 / IS-GPS-200 20.3.3.5.2.4 'before event' branch:
        t_UTC = tow - (dt_ls + a0 + a1*(tow - t0t + 604800*(WN - WN0t)))."""
        dt = (self.dt_ls + self.a0
              + self.a1 * (tow_s - self.t0t
                           + 604800.0 * ((week - self.wn0t) % 256)))
        return tow_s - dt


class IonoParams(NamedTuple):
    """Klobuchar ionosphere model coefficients (IS-GPS-200 20.3.3.5.1.7,
    broadcast in subframe 4 page 18). The reference discards them
    (sdrnav_gps.c:71-73 reads only the ToW of subframes 4/5)."""
    alpha: tuple = (0.0, 0.0, 0.0, 0.0)   # s, s/sc, s/sc^2, s/sc^3
    beta: tuple = (0.0, 0.0, 0.0, 0.0)    # s, s/sc, ...


@dataclasses.dataclass
class AlmanacEntry:
    """Reduced-precision almanac orbit (subframe 5 pages 1-24,
    IS-GPS-200 20.3.3.5.1.2)."""
    prn: int = 0
    e: float = 0.0
    toa: float = 0.0
    delta_i: float = 0.0       # rad, offset from 0.30 semicircles
    omega_dot: float = 0.0
    health: int = 0
    sqrt_a: float = 0.0
    omega0: float = 0.0
    omega: float = 0.0
    m0: float = 0.0
    af0: float = 0.0
    af1: float = 0.0


_PI = 3.1415926535898      # ICD semicircle constant (rtklib SC2RAD)

# (field, word index 0-based, bit slice within 24 data bits, signed, scale)
# Subframe layouts per IS-GPS-200 fig. 20-1. Word index counts from the TLM
# word (0); data-bit slices are within each word's 24 source bits.


def _sf1_fields(data: np.ndarray) -> dict:
    week = unpack_u(data[2][0:10])
    ura = unpack_u(data[2][12:16])
    health = unpack_u(data[2][16:22])
    iodc = (unpack_u(data[2][22:24]) << 8) | unpack_u(data[7][0:8])
    tgd = unpack_s(data[6][16:24]) * 2.0 ** -31
    toc = unpack_u(data[7][8:24]) * 16.0
    af2 = unpack_s(data[8][0:8]) * 2.0 ** -55
    af1 = unpack_s(data[8][8:24]) * 2.0 ** -43
    af0 = unpack_s(data[9][0:22]) * 2.0 ** -31
    return dict(week=week, ura=ura, health=health, iodc=iodc, tgd=tgd,
                toc=toc, af2=af2, af1=af1, af0=af0)


def _sf2_fields(data: np.ndarray) -> dict:
    iode = unpack_u(data[2][0:8])
    crs = unpack_s(data[2][8:24]) * 2.0 ** -5
    delta_n = unpack_s(data[3][0:16]) * 2.0 ** -43 * _PI
    m0 = ((unpack_s(np.concatenate([data[3][16:24], data[4][0:24]]))
           ) * 2.0 ** -31 * _PI)
    cuc = unpack_s(data[5][0:16]) * 2.0 ** -29
    e = ((unpack_u(np.concatenate([data[5][16:24], data[6][0:24]]))
          ) * 2.0 ** -33)
    cus = unpack_s(data[7][0:16]) * 2.0 ** -29
    sqrt_a = ((unpack_u(np.concatenate([data[7][16:24], data[8][0:24]]))
               ) * 2.0 ** -19)
    toe = unpack_u(data[9][0:16]) * 16.0
    return dict(iode=iode, crs=crs, delta_n=delta_n, m0=m0, cuc=cuc, e=e,
                cus=cus, sqrt_a=sqrt_a, toe=toe)


def _sf3_fields(data: np.ndarray) -> dict:
    cic = unpack_s(data[2][0:16]) * 2.0 ** -29
    omega0 = ((unpack_s(np.concatenate([data[2][16:24], data[3][0:24]]))
               ) * 2.0 ** -31 * _PI)
    cis = unpack_s(data[4][0:16]) * 2.0 ** -29
    i0 = ((unpack_s(np.concatenate([data[4][16:24], data[5][0:24]]))
           ) * 2.0 ** -31 * _PI)
    crc = unpack_s(data[6][0:16]) * 2.0 ** -5
    omega = ((unpack_s(np.concatenate([data[6][16:24], data[7][0:24]]))
              ) * 2.0 ** -31 * _PI)
    omega_dot = unpack_s(data[8][0:24]) * 2.0 ** -43 * _PI
    iode = unpack_u(data[9][0:8])
    idot = unpack_s(data[9][8:22]) * 2.0 ** -43 * _PI
    return dict(cic=cic, omega0=omega0, cis=cis, i0=i0, crc=crc, omega=omega,
                omega_dot=omega_dot, iode=iode, idot=idot)


def _sf1_words(eph: "Ephemeris", tow_count: int) -> np.ndarray:
    """Subframe 1 source data words (10, 24) for the encoder."""
    w = np.zeros((10, 24), dtype=np.int64)
    w[0][0:8] = PREAMBLE
    w[1][0:17] = pack_bits(tow_count, 17)
    w[1][19:22] = pack_bits(1, 3)                 # subframe ID
    w[2][0:10] = pack_bits(eph.week, 10)
    w[2][12:16] = pack_bits(eph.ura, 4)
    w[2][16:22] = pack_bits(eph.health, 6)
    w[2][22:24] = pack_bits(eph.iodc >> 8, 2)
    w[6][16:24] = pack_bits(int(round(eph.tgd / 2.0 ** -31)), 8)
    w[7][0:8] = pack_bits(eph.iodc & 0xFF, 8)
    w[7][8:24] = pack_bits(int(round(eph.toc / 16.0)), 16)
    w[8][0:8] = pack_bits(int(round(eph.af2 / 2.0 ** -55)), 8)
    w[8][8:24] = pack_bits(int(round(eph.af1 / 2.0 ** -43)), 16)
    w[9][0:22] = pack_bits(int(round(eph.af0 / 2.0 ** -31)), 22)
    return w


def _sf2_words(eph: "Ephemeris", tow_count: int) -> np.ndarray:
    w = np.zeros((10, 24), dtype=np.int64)
    w[0][0:8] = PREAMBLE
    w[1][0:17] = pack_bits(tow_count, 17)
    w[1][19:22] = pack_bits(2, 3)
    w[2][0:8] = pack_bits(eph.iode, 8)
    w[2][8:24] = pack_bits(int(round(eph.crs / 2.0 ** -5)), 16)
    w[3][0:16] = pack_bits(int(round(eph.delta_n / _PI / 2.0 ** -43)), 16)
    m0 = pack_bits(int(round(eph.m0 / _PI / 2.0 ** -31)), 32)
    w[3][16:24] = m0[0:8]
    w[4][0:24] = m0[8:32]
    w[5][0:16] = pack_bits(int(round(eph.cuc / 2.0 ** -29)), 16)
    ecc = pack_bits(int(round(eph.e / 2.0 ** -33)), 32)
    w[5][16:24] = ecc[0:8]
    w[6][0:24] = ecc[8:32]
    w[7][0:16] = pack_bits(int(round(eph.cus / 2.0 ** -29)), 16)
    sa = pack_bits(int(round(eph.sqrt_a / 2.0 ** -19)), 32)
    w[7][16:24] = sa[0:8]
    w[8][0:24] = sa[8:32]
    w[9][0:16] = pack_bits(int(round(eph.toe / 16.0)), 16)
    return w


def _sf3_words(eph: "Ephemeris", tow_count: int) -> np.ndarray:
    w = np.zeros((10, 24), dtype=np.int64)
    w[0][0:8] = PREAMBLE
    w[1][0:17] = pack_bits(tow_count, 17)
    w[1][19:22] = pack_bits(3, 3)
    w[2][0:16] = pack_bits(int(round(eph.cic / 2.0 ** -29)), 16)
    om0 = pack_bits(int(round(eph.omega0 / _PI / 2.0 ** -31)), 32)
    w[2][16:24] = om0[0:8]
    w[3][0:24] = om0[8:32]
    w[4][0:16] = pack_bits(int(round(eph.cis / 2.0 ** -29)), 16)
    i0b = pack_bits(int(round(eph.i0 / _PI / 2.0 ** -31)), 32)
    w[4][16:24] = i0b[0:8]
    w[5][0:24] = i0b[8:32]
    w[6][0:16] = pack_bits(int(round(eph.crc / 2.0 ** -5)), 16)
    omb = pack_bits(int(round(eph.omega / _PI / 2.0 ** -31)), 32)
    w[6][16:24] = omb[0:8]
    w[7][0:24] = omb[8:32]
    w[8][0:24] = pack_bits(int(round(eph.omega_dot / _PI / 2.0 ** -43)), 24)
    w[9][0:8] = pack_bits(eph.iode, 8)
    w[9][8:22] = pack_bits(int(round(eph.idot / _PI / 2.0 ** -43)), 14)
    return w


_UTC_PAGE_SVID = 56            # subframe 4 page 18 carries iono + UTC


def _sf4_fields(data: np.ndarray) -> dict:
    """Subframe 4: only page 18 (SV ID 56: iono + UTC) carries fields the
    receiver consumes; other pages are recognized but skipped. Bit layout
    IS-GPS-200 20.3.3.5.1.7/.1.8 — beyond the reference, which reads only
    the ToW of subframes 4/5 (sdrnav_gps.c:71-77)."""
    svid = unpack_u(data[2][2:8])
    if svid != _UTC_PAGE_SVID:
        return {}
    iono = IonoParams(
        alpha=(unpack_s(data[2][8:16]) * 2.0 ** -30,
               unpack_s(data[2][16:24]) * 2.0 ** -27,
               unpack_s(data[3][0:8]) * 2.0 ** -24,
               unpack_s(data[3][8:16]) * 2.0 ** -24),
        beta=(unpack_s(data[3][16:24]) * 2.0 ** 11,
              unpack_s(data[4][0:8]) * 2.0 ** 14,
              unpack_s(data[4][8:16]) * 2.0 ** 16,
              unpack_s(data[4][16:24]) * 2.0 ** 16))
    utc = UtcParams(
        a1=unpack_s(data[5][0:24]) * 2.0 ** -50,
        a0=unpack_s(np.concatenate([data[6][0:24], data[7][0:8]]))
        * 2.0 ** -30,
        t0t=unpack_u(data[7][8:16]) * 2.0 ** 12,
        wn0t=unpack_u(data[7][16:24]),
        dt_ls=unpack_s(data[8][0:8]),
        wn_lsf=unpack_u(data[8][8:16]),
        dn=unpack_u(data[8][16:24]),
        dt_lsf=unpack_s(data[9][0:8]))
    return {"iono": iono, "utc": utc}


def _sf5_fields(data: np.ndarray) -> dict:
    """Subframe 5 pages 1-24: almanac for SV 1-24 (IS-GPS-200
    20.3.3.5.1.2). Page 25 (SV ID 51: health summary) is skipped."""
    svid = unpack_u(data[2][2:8])
    if not 1 <= svid <= 32:
        return {}
    alm = AlmanacEntry(
        prn=svid,
        e=unpack_u(data[2][8:24]) * 2.0 ** -21,
        toa=unpack_u(data[3][0:8]) * 2.0 ** 12,
        delta_i=unpack_s(data[3][8:24]) * 2.0 ** -19 * _PI,
        omega_dot=unpack_s(data[4][0:16]) * 2.0 ** -38 * _PI,
        health=unpack_u(data[4][16:24]),
        sqrt_a=unpack_u(data[5][0:24]) * 2.0 ** -11,
        omega0=unpack_s(data[6][0:24]) * 2.0 ** -23 * _PI,
        omega=unpack_s(data[7][0:24]) * 2.0 ** -23 * _PI,
        m0=unpack_s(data[8][0:24]) * 2.0 ** -23 * _PI,
        af0=unpack_s(np.concatenate([data[9][0:8], data[9][19:22]]))
        * 2.0 ** -20,
        af1=unpack_s(data[9][8:19]) * 2.0 ** -38)
    return {"almanac_entry": alm}


def _sf4_words(eph: "Ephemeris", tow_count: int) -> np.ndarray:
    """Subframe 4 page 18 fixture builder (iono + UTC)."""
    w = np.zeros((10, 24), dtype=np.int64)
    w[0][0:8] = PREAMBLE
    w[1][0:17] = pack_bits(tow_count, 17)
    w[1][19:22] = pack_bits(4, 3)
    w[2][0:2] = pack_bits(1, 2)                    # data ID
    w[2][2:8] = pack_bits(_UTC_PAGE_SVID, 6)
    io = eph.iono or IonoParams()
    u = eph.utc or UtcParams()
    w[2][8:16] = pack_bits(int(round(io.alpha[0] / 2.0 ** -30)), 8)
    w[2][16:24] = pack_bits(int(round(io.alpha[1] / 2.0 ** -27)), 8)
    w[3][0:8] = pack_bits(int(round(io.alpha[2] / 2.0 ** -24)), 8)
    w[3][8:16] = pack_bits(int(round(io.alpha[3] / 2.0 ** -24)), 8)
    w[3][16:24] = pack_bits(int(round(io.beta[0] / 2.0 ** 11)), 8)
    w[4][0:8] = pack_bits(int(round(io.beta[1] / 2.0 ** 14)), 8)
    w[4][8:16] = pack_bits(int(round(io.beta[2] / 2.0 ** 16)), 8)
    w[4][16:24] = pack_bits(int(round(io.beta[3] / 2.0 ** 16)), 8)
    w[5][0:24] = pack_bits(int(round(u.a1 / 2.0 ** -50)), 24)
    a0 = pack_bits(int(round(u.a0 / 2.0 ** -30)), 32)
    w[6][0:24] = a0[0:24]
    w[7][0:8] = a0[24:32]
    w[7][8:16] = pack_bits(int(round(u.t0t / 2.0 ** 12)), 8)
    w[7][16:24] = pack_bits(int(u.wn0t), 8)
    w[8][0:8] = pack_bits(int(u.dt_ls), 8)
    w[8][8:16] = pack_bits(int(u.wn_lsf), 8)
    w[8][16:24] = pack_bits(int(u.dn), 8)
    w[9][0:8] = pack_bits(int(u.dt_lsf), 8)
    return w


def _sf5_words(eph: "Ephemeris", tow_count: int,
               alm_prn: int | None = None) -> np.ndarray:
    """Subframe 5 almanac-page fixture builder (page = alm PRN)."""
    w = np.zeros((10, 24), dtype=np.int64)
    w[0][0:8] = PREAMBLE
    w[1][0:17] = pack_bits(tow_count, 17)
    w[1][19:22] = pack_bits(5, 3)
    if not eph.almanac:
        return w
    if alm_prn is None:
        alm_prn = sorted(eph.almanac)[0]
    a = eph.almanac[alm_prn]
    w[2][0:2] = pack_bits(1, 2)
    w[2][2:8] = pack_bits(a.prn, 6)
    w[2][8:24] = pack_bits(int(round(a.e / 2.0 ** -21)), 16)
    w[3][0:8] = pack_bits(int(round(a.toa / 2.0 ** 12)), 8)
    w[3][8:24] = pack_bits(int(round(a.delta_i / _PI / 2.0 ** -19)), 16)
    w[4][0:16] = pack_bits(int(round(a.omega_dot / _PI / 2.0 ** -38)), 16)
    w[4][16:24] = pack_bits(a.health, 8)
    w[5][0:24] = pack_bits(int(round(a.sqrt_a / 2.0 ** -11)), 24)
    w[6][0:24] = pack_bits(int(round(a.omega0 / _PI / 2.0 ** -23)), 24)
    w[7][0:24] = pack_bits(int(round(a.omega / _PI / 2.0 ** -23)), 24)
    w[8][0:24] = pack_bits(int(round(a.m0 / _PI / 2.0 ** -23)), 24)
    af0 = pack_bits(int(round(a.af0 / 2.0 ** -20)), 11)
    w[9][0:8] = af0[0:8]
    w[9][19:22] = af0[8:11]
    w[9][8:19] = pack_bits(int(round(a.af1 / 2.0 ** -38)), 11)
    return w


_SF_BUILDERS = {1: _sf1_words, 2: _sf2_words, 3: _sf3_words,
                4: _sf4_words, 5: _sf5_words}
_SF_PARSERS = {1: _sf1_fields, 2: _sf2_fields, 3: _sf3_fields,
               4: _sf4_fields, 5: _sf5_fields}


def encode_frames(eph: "Ephemeris", start_tow_s: float,
                  n_subframes: int, cycle=(1, 2, 3)) -> np.ndarray:
    """Encode a run of consecutive subframes cycling `cycle` as 0/1 bits
    (default 1,2,3,... — pass (1,2,3,4,5) for the full IS-GPS-200 frame;
    subframe 4 emits the iono/UTC page 18, subframe 5 cycles the almanac
    pages for eph.almanac's PRNs).

    start_tow_s must be a multiple of 6 s. The HOW carries the TOW count of
    the NEXT subframe boundary (IS-GPS-200 20.3.3.2): tow_count =
    (tow_s + 6)/6.
    """
    assert start_tow_s % 6 == 0
    out = []
    d29 = d30 = 0
    alm_prns = sorted(eph.almanac) or [None]
    n_sf5 = 0
    for k in range(n_subframes):
        tow_s = start_tow_s + 6 * k
        sf_id = cycle[k % len(cycle)]
        tow_count = int((tow_s + 6.0) // 6.0)
        if sf_id == 5:
            words = _sf5_words(eph, tow_count,
                               alm_prn=alm_prns[n_sf5 % len(alm_prns)])
            n_sf5 += 1
        else:
            words = _SF_BUILDERS[sf_id](eph, tow_count)
        sf = encode_subframe(words, d29, d30)
        d29, d30 = int(sf[-2]), int(sf[-1])
        out.append(sf)
    return np.concatenate(out)


def find_preamble(bits: np.ndarray) -> list[int]:
    """Candidate subframe starts: preamble match at i AND at i+300
    (findpreamble's double-preamble gate, sdrnav.c:284-328).

    Each word's polarity depends on the previous word's D30*, so the two
    preambles are matched with INDEPENDENT polarity; parity later confirms.
    """
    bits = np.asarray(bits, dtype=np.int64) & 1
    n = bits.size
    cands = []
    for i in range(0, n - SUBFRAME_BITS - 8):
        w = bits[i:i + 8]
        w2 = bits[i + SUBFRAME_BITS:i + SUBFRAME_BITS + 8]
        ok1 = np.array_equal(w, PREAMBLE) or np.array_equal(w ^ 1, PREAMBLE)
        ok2 = np.array_equal(w2, PREAMBLE) or np.array_equal(w2 ^ 1, PREAMBLE)
        if ok1 and ok2:
            cands.append(i)
    return cands


def decode_subframe(bits300: np.ndarray, d29: int = 0, d30: int = 0):
    """Parity-check + parse one subframe given the previous word's raw
    parity tail (D29*, D30*). Returns (sf_id, fields, tow_s) or
    (None, None, None). Polarity is implicit: the D30* complement rule
    de-inverts data during the parity check (check_word)."""
    b = np.asarray(bits300, dtype=np.int64) & 1
    ok, data = check_subframe(b, d29, d30)
    if not ok or not np.array_equal(data[0][0:8], PREAMBLE):
        return None, None, None
    sf_id = unpack_u(data[1][19:22])
    tow_count = unpack_u(data[1][0:17])
    tow_s = tow_count * 6.0 - 6.0              # HOW holds next-subframe TOW
    if sf_id in _SF_PARSERS:
        return sf_id, _SF_PARSERS[sf_id](data), tow_s
    return sf_id, {}, tow_s


def decode_stream(bits: np.ndarray, prn: int = 0):
    """Full decode of a nav bit stream: preamble sync -> subframes -> eph.

    `bits` are hard decisions (0/1) at 50 bps, any polarity/alignment. The
    first word's incoming (D29*, D30*) are unknown, so all four seeds are
    tried and parity + preamble arbitrate (sdrnav.c:284-328 equivalent).

    Returns (Ephemeris, anchors) where anchors is a list of
    (bit_index, sf_id, tow_s): the stream bit index of each decoded
    subframe's first bit and the GPS ToW of that bit's leading edge — the
    timing anchors pseudorange formation needs (sdrsync.c:81-93 role).
    """
    eph = Ephemeris(prn=prn)
    have = []
    anchors = []
    bits = np.asarray(bits, dtype=np.int64) & 1
    # worklist: double-preamble candidates, plus the position right after
    # every successfully decoded subframe (covers the stream tail, which
    # has no following preamble to certify it)
    queue = sorted(set(find_preamble(bits)))
    processed: set[int] = set()
    while queue:
        start = queue.pop(0)
        if start in processed or start + SUBFRAME_BITS > bits.size:
            continue
        processed.add(start)
        sf_bits = bits[start:start + SUBFRAME_BITS]
        # seed candidates: the two raw bits preceding this subframe first
        # (each subframe re-syncs independently so a jam-corrupted
        # neighbour cannot poison it), then all four combos as fallback
        seed_cands = []
        if start >= 2:
            seed_cands.append((int(bits[start - 2]), int(bits[start - 1])))
        seed_cands += [(a, b) for a in (0, 1) for b in (0, 1)]
        for d29, d30 in seed_cands:
            sf_id, fields, tow_s = decode_subframe(sf_bits, d29, d30)
            if sf_id is None:
                continue
            anchors.append((start, sf_id, tow_s))
            if fields:
                for name, val in fields.items():
                    if name == "almanac_entry":
                        eph.almanac[val.prn] = val
                    else:
                        setattr(eph, name, val)
                eph.tow_s = tow_s
                if sf_id not in have:
                    have.append(sf_id)
            nxt = start + SUBFRAME_BITS
            if nxt not in processed:
                queue.append(nxt)
                queue.sort()
            break
    anchors.sort()
    eph.have_subframes = tuple(have)
    return eph, anchors


def decode_bits(bits: np.ndarray, prn: int = 0) -> "Ephemeris":
    """Ephemeris-only wrapper of `decode_stream`."""
    return decode_stream(bits, prn)[0]
