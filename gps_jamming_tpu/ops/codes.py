"""PRN spreading-code generation and resampling.

Device-side equivalent of `sdrcode.c` (gencode dispatch :598-623) and `rescode`
(sdrcmn.c:527-579). Codes are generated once on the host from the published
LFSR definitions (IS-GPS-200 for L1 C/A, GLONASS ICD for the 511-chip G1
sequence), cached, and shipped to device as +/-1 float tables; resampling to
the capture sample rate is a vectorized gather, and acquisition replicas are
precomputed as conj(FFT(.)) tables exactly like the reference precomputes
FFT-domain replicas at channel init (sdrinit.c:431-442).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import constants as C

# IS-GPS-200 G2 phase-selector tap pairs (1-indexed) for PRN 1..32.
_GPS_G2_TAPS = [
    (2, 6), (3, 7), (4, 8), (5, 9), (1, 9), (2, 10), (1, 8), (2, 9),
    (3, 10), (2, 3), (3, 4), (5, 6), (6, 7), (7, 8), (8, 9), (9, 10),
    (1, 4), (2, 5), (3, 6), (4, 7), (5, 8), (6, 9), (1, 3), (4, 6),
    (5, 7), (6, 8), (7, 9), (8, 10), (1, 6), (2, 7), (3, 8), (4, 9),
]


@functools.lru_cache(maxsize=64)
def gps_ca_code(prn: int) -> np.ndarray:
    """GPS L1 C/A code for one PRN as +/-1 int8, length 1023.

    Gold code: G1 (x^10 + x^3 + 1) XOR a two-tap phase of G2
    (x^10 + x^9 + x^8 + x^6 + x^3 + x^2 + 1). Same math as sdrcode.c:102-150
    expressed via the standard ICD LFSR definition.
    """
    if not 1 <= prn <= 32:
        raise ValueError(f"GPS PRN must be 1..32, got {prn}")
    t1, t2 = _GPS_G2_TAPS[prn - 1]
    g1 = np.ones(10, dtype=np.int8)
    g2 = np.ones(10, dtype=np.int8)
    out = np.empty(1023, dtype=np.int8)
    for i in range(1023):
        chip = g1[9] ^ (g2[t1 - 1] ^ g2[t2 - 1])
        out[i] = 1 - 2 * chip           # 0 -> +1, 1 -> -1
        fb1 = g1[2] ^ g1[9]
        fb2 = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]
        g1[1:] = g1[:-1]
        g1[0] = fb1
        g2[1:] = g2[:-1]
        g2[0] = fb2
    return out


# Published G2 delays (chips) for SBAS PRN 120..138 (DO-229 / the
# IS-GPS-200 C/A family extension; same constants as the sdrcode.c:103-119
# delay table rows 120..138).
_SBAS_G2_DELAY = {
    120: 145, 121: 175, 122: 52, 123: 21, 124: 237, 125: 235, 126: 886,
    127: 657, 128: 634, 129: 762, 130: 355, 131: 1012, 132: 176, 133: 603,
    134: 130, 135: 359, 136: 595, 137: 68, 138: 386,
}


@functools.lru_cache(maxsize=1)
def _ca_base_sequences() -> tuple[np.ndarray, np.ndarray]:
    """Full-period (1023,) 0/1 G1 and G2 maximal-length sequences of the
    C/A family (G1: x^10+x^3+1; G2: x^10+x^9+x^8+x^6+x^3+x^2+1)."""
    g1 = np.ones(10, dtype=np.int8)
    g2 = np.ones(10, dtype=np.int8)
    s1 = np.empty(1023, np.int8)
    s2 = np.empty(1023, np.int8)
    for i in range(1023):
        s1[i] = g1[9]
        s2[i] = g2[9]
        fb1 = g1[2] ^ g1[9]
        fb2 = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]
        g1[1:] = g1[:-1]
        g1[0] = fb1
        g2[1:] = g2[:-1]
        g2[0] = fb2
    return s1, s2


def ca_code_from_delay(delay_chips: int) -> np.ndarray:
    """C/A-family Gold code as +/-1 int8 from a G2 circular delay.

    The delay formulation is equivalent to the per-PRN G2 tap pairs:
    C(t) = G1(t) xor G2((t - delay) mod 1023) (sdrcode.c:143-145 form)."""
    s1, s2 = _ca_base_sequences()
    idx = (np.arange(1023) - delay_chips) % 1023
    return (1 - 2 * (s1 ^ s2[idx])).astype(np.int8)


@functools.lru_cache(maxsize=32)
def sbas_ca_code(prn: int) -> np.ndarray:
    """SBAS L1 C/A code for PRN 120..138 as +/-1 int8, length 1023."""
    if prn not in _SBAS_G2_DELAY:
        raise ValueError(f"SBAS PRN must be 120..138, got {prn}")
    return ca_code_from_delay(_SBAS_G2_DELAY[prn])


def sbas_ca_table() -> np.ndarray:
    """(19, 1023) float32 table of all SBAS C/A codes (PRN 120..138)."""
    return np.stack([sbas_ca_code(p)
                     for p in sorted(_SBAS_G2_DELAY)]).astype(np.float32)


@functools.lru_cache(maxsize=1)
def glonass_code() -> np.ndarray:
    """GLONASS 511-chip ranging code as +/-1 int8 (all FDMA channels share it).

    9-stage LFSR x^9 + x^5 + 1, output from stage 7 (GLONASS ICD; the same
    sequence sdrcode.c:553-571 produces).
    """
    reg = np.ones(9, dtype=np.int8)
    out = np.empty(511, dtype=np.int8)
    for i in range(511):
        out[i] = 1 - 2 * reg[6]
        fb = reg[4] ^ reg[8]
        reg[1:] = reg[:-1]
        reg[0] = fb
    return out


# IS-GPS-800 L1C Weil indices (w) and expansion insertion points (p,
# 1-based) for PRN 1..63 — published ICD constants (same role as the
# tables sdrcode.c:162-310 embeds for its gencode_L1CP/L1CD).
_L1CP_WEIL = (
    5111, 5109, 5108, 5106, 5103, 5101, 5100, 5098, 5095, 5094, 5093,
    5091, 5090, 5081, 5080, 5069, 5068, 5054, 5044, 5027, 5026, 5014,
    5004, 4980, 4915, 4909, 4893, 4885, 4832, 4824, 4591, 3706, 5092,
    4986, 4965, 4920, 4917, 4858, 4847, 4790, 4770, 4318, 4126, 3961,
    3790, 4911, 4881, 4827, 4795, 4789, 4725, 4675, 4539, 4535, 4458,
    4197, 4096, 3484, 3481, 3393, 3175, 2360, 1852)
_L1CP_INSERT = (
    412, 161, 1, 303, 207, 4971, 4496, 5, 4557, 485, 253, 4676, 1, 66,
    4485, 282, 193, 5211, 729, 4848, 982, 5955, 9805, 670, 464, 29, 429,
    394, 616, 9457, 4429, 4771, 365, 9705, 9489, 4193, 9947, 824, 864,
    347, 677, 6544, 6312, 9804, 278, 9461, 444, 4839, 4144, 9875, 197,
    1156, 4674, 10035, 4504, 5, 9937, 430, 5, 355, 909, 1622, 6284)
_L1CD_WEIL = (
    5097, 5110, 5079, 4403, 4121, 5043, 5042, 5104, 4940, 5035, 4372,
    5064, 5084, 5048, 4950, 5019, 5076, 3736, 4993, 5060, 5061, 5096,
    4983, 4783, 4991, 4815, 4443, 4769, 4879, 4894, 4985, 5056, 4921,
    5036, 4812, 4838, 4855, 4904, 4753, 4483, 4942, 4813, 4957, 4618,
    4669, 4969, 5031, 5038, 4740, 4073, 4843, 4979, 4867, 4964, 5025,
    4579, 4390, 4763, 4612, 4784, 3716, 4703, 4851)
_L1CD_INSERT = (
    181, 359, 72, 1110, 1480, 5034, 4622, 1, 4547, 826, 6284, 4195,
    368, 1, 4796, 523, 151, 713, 9850, 5734, 34, 6142, 190, 644, 467,
    5384, 801, 594, 4450, 9437, 4307, 5906, 378, 9448, 9432, 5849,
    5547, 9546, 9132, 403, 3766, 3, 684, 9711, 333, 6124, 10216, 4251,
    9893, 9884, 4627, 4449, 9798, 985, 4272, 126, 10024, 434, 1029,
    561, 289, 638, 4353)
_WEIL_P = 10223
_L1C_LEN = 10230
_L1C_EXPANSION = np.array([0, 1, 1, 0, 1, 0, 0], np.int8)


@functools.lru_cache(maxsize=1)
def legendre_10223() -> np.ndarray:
    """Legendre sequence L(t): 1 when t is a nonzero quadratic residue
    mod 10223, else 0 (L(0)=0) — the base sequence of all L1C Weil codes
    (IS-GPS-800 3.2.2.1.1; same math as sdrcode.c's legendre table)."""
    residues = np.zeros(_WEIL_P, np.int8)
    x = np.arange(1, _WEIL_P, dtype=np.int64)
    residues[(x * x) % _WEIL_P] = 1
    residues[0] = 0
    return residues


def weil_code(weil_index: int, insert_1based: int) -> np.ndarray:
    """10230-chip L1C spreading code as +/-1 int8 (0 -> +1).

    Weil sequence W(t) = L(t) xor L((t + w) mod 10223), with the 7-chip
    expansion 0110100 inserted at the 1-based insertion point
    (IS-GPS-800 3.2.2.1.1/.2; gencode_L1CP role, sdrcode.c:162-233)."""
    L = legendre_10223()
    t = np.arange(_WEIL_P)
    w = L ^ L[(t + weil_index) % _WEIL_P]
    p = insert_1based - 1
    bits = np.concatenate([w[:p], _L1C_EXPANSION, w[p:]])
    assert bits.size == _L1C_LEN
    return (1 - 2 * bits).astype(np.int8)


@functools.lru_cache(maxsize=128)
def gps_l1cp_code(prn: int) -> np.ndarray:
    """L1C pilot spreading code (before TMBOC/overlay), PRN 1..63."""
    if not 1 <= prn <= len(_L1CP_WEIL):
        raise ValueError(f"L1CP PRN must be 1..{len(_L1CP_WEIL)}")
    return weil_code(_L1CP_WEIL[prn - 1], _L1CP_INSERT[prn - 1])


@functools.lru_cache(maxsize=128)
def gps_l1cd_code(prn: int) -> np.ndarray:
    """L1C data spreading code, PRN 1..63."""
    if not 1 <= prn <= len(_L1CD_WEIL):
        raise ValueError(f"L1CD PRN must be 1..{len(_L1CD_WEIL)}")
    return weil_code(_L1CD_WEIL[prn - 1], _L1CD_INSERT[prn - 1])


def nh10() -> np.ndarray:
    """10-bit Neuman-Hofman overlay 0000110101 as +/-1 (0 -> +1), 1 kcps
    (gencode_NH10 role)."""
    bits = np.array([0, 0, 0, 0, 1, 1, 0, 1, 0, 1], np.int8)
    return (1 - 2 * bits).astype(np.int8)


def nh20() -> np.ndarray:
    """20-bit Neuman-Hofman overlay 00000100110101001110, 500 cps
    (gencode_NH20 role)."""
    bits = np.array([0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 0, 1, 0, 0,
                     1, 1, 1, 0], np.int8)
    return (1 - 2 * bits).astype(np.int8)


def boc11(code: np.ndarray) -> np.ndarray:
    """BOC(1,1) modulation: each chip split into (+c, -c) half-chips.

    Used by Galileo E1B/E1C (sdrcode.c:573-596). Doubles the chip rate.
    """
    return np.stack([code, -code], axis=-1).reshape(-1).astype(np.int8)


@functools.lru_cache(maxsize=8)
def gps_ca_table() -> np.ndarray:
    """(32, 1023) float32 table of all GPS C/A codes."""
    return np.stack([gps_ca_code(p) for p in range(1, 33)]).astype(np.float32)


def resample_code(code: jax.Array, code_freq_hz: float | jax.Array,
                  sample_rate_hz: float, n_samples: int,
                  rem_chips: float | jax.Array = 0.0,
                  chip_shift: float | jax.Array = 0.0) -> jax.Array:
    """Nearest(floor)-neighbor resample of a chip sequence to sample rate.

    chip index for sample i: floor(rem + chip_shift + i * fcode/fs) mod clen —
    the `rescode` contract (sdrcmn.c:527-579). Batches over leading dims of
    `code`; `rem_chips`/`chip_shift` may be traced scalars.
    """
    clen = code.shape[-1]
    i = jnp.arange(n_samples, dtype=jnp.float32)
    phase = rem_chips + chip_shift + i * (code_freq_hz / sample_rate_hz)
    idx = jnp.floor(phase).astype(jnp.int32) % clen
    return jnp.take(code, idx, axis=-1)


def resample_code_bandlimited(code: jax.Array, code_freq_hz: float,
                              sample_rate_hz: float, n_samples: int,
                              rem_chips: float = 0.0,
                              oversample: int = 4) -> jax.Array:
    """Band-limited resample of a chip sequence (simulation-side).

    Models the receiver front-end: the code waveform is sampled at
    `oversample x sample_rate`, brick-wall filtered to +/- sample_rate/2,
    and decimated. Without this, nearest-neighbor sampling of square-wave
    codes aliases out-of-band lines into the Doppler search band — e.g.
    BOC(1,1)'s doubled-subcarrier product at 2.046 MHz folds to -2 kHz at
    a 2.048 MS/s rate, which can out-power the true acquisition peak. A
    real capture never contains that line (the RTL-SDR front-end filters
    before sampling), so synthetic fixtures must not either.
    """
    n_hi = n_samples * oversample
    hi = resample_code(code, code_freq_hz, sample_rate_hz * oversample,
                       n_hi, rem_chips)
    spec = jnp.fft.fft(hi.astype(jnp.complex64), axis=-1)
    keep = n_samples // 2
    low = jnp.concatenate([spec[..., :keep], spec[..., -keep:]], axis=-1)
    # ifft(n_samples) normalizes by n_samples, not n_hi: rescale by 1/os
    return (jnp.real(jnp.fft.ifft(low, axis=-1)) / oversample) \
        .astype(jnp.float32)


def sampled_code_fft_conj(code_table: np.ndarray, code_freq_hz: float,
                          sample_rate_hz: float, n_samples: int) -> jax.Array:
    """Precompute conj(FFT(sampled code)) replicas for acquisition.

    code_table: (n_code, clen) +/-1 floats -> (n_code, n_samples) complex64.
    Mirrors the FFT-domain replica precompute of sdrinit.c:431-442.
    """
    codes = jnp.asarray(code_table, dtype=jnp.float32)
    sampled = resample_code(codes, code_freq_hz, sample_rate_hz, n_samples)
    return jnp.conj(jnp.fft.fft(sampled.astype(jnp.complex64)))


def resample_code_np(code_table: np.ndarray, code_freq_hz: float,
                     sample_rate_hz: float, n_samples: int,
                     rem_chips: float = 0.0) -> np.ndarray:
    """Host (numpy) twin of `resample_code` for init-time precompute."""
    clen = code_table.shape[-1]
    phase = rem_chips + np.arange(n_samples) * (code_freq_hz / sample_rate_hz)
    idx = np.floor(phase).astype(np.int64) % clen
    return np.take(code_table, idx, axis=-1).astype(np.float32)


def sampled_code_fft_conj_host(code_table: np.ndarray, code_freq_hz: float,
                               sample_rate_hz: float,
                               n_samples: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-precomputed conj(FFT(sampled code)) as (re, im) float32 planes.

    The replica table: computed once at init on the host with numpy
    (mirroring the one-shot precompute of sdrinit.c:431-442) and fed to
    jitted planar kernels as embedded constants — device arrays never
    cross back to host during lowering.
    """
    sampled = resample_code_np(np.asarray(code_table, np.float32),
                               code_freq_hz, sample_rate_hz, n_samples)
    rep = np.conj(np.fft.fft(sampled, axis=-1))
    return (np.ascontiguousarray(rep.real, np.float32),
            np.ascontiguousarray(rep.imag, np.float32))


def glonass_carrier_hz(freq_ch: int) -> float:
    """GLONASS FDMA carrier for channel number k (sdrinit.c:391-399 maps
    prn -> k = prn - 8)."""
    return C.GLO_G1_BASE_FREQ_HZ + freq_ch * C.GLO_G1_CH_SPACING_HZ
