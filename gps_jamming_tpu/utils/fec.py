"""Convolutional FEC: K=7 rate-1/2 encoder + Viterbi decoder (numpy).

Replaces the reference's libfec dependency (`predecodefec`,
sdrnav.c:194-236, used for SBAS and — in spirit — Galileo I/NAV). The
generator polynomials are the CCSDS/Galileo pair G1=171o, G2=133o; Galileo
E1B additionally INVERTS the second branch (ICD 4.1.4), controlled by
`invert_g2`. Vectorized over the 64-state trellis so decoding a 240-symbol
page is a handful of numpy ops per step (host-side: bit-rate work stays
off the device per SURVEY.md §7).
"""
from __future__ import annotations

import numpy as np

K = 7
_NSTATES = 64
_G1 = 0o171
_G2 = 0o133


def _parity(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> 16
    x ^= x >> 8
    x ^= x >> 4
    x ^= x >> 2
    x ^= x >> 1
    return x & 1


# transition tables: for state s (6 bits of history, newest in MSB?) we use
# the convention: register = [b_new, b_old1, ..., b_old5]; state = 6 most
# recent bits with the newest bit as the LOW bit.
_STATES = np.arange(_NSTATES, dtype=np.uint32)
# output bits for (input u, state s): register value r = u<<6 | s  (u is
# the OLDEST bit in G terms? choose: r = (s << 1 | u) is the 7-bit window
# with u newest). Encoder shifts u in; window = u + previous 6 bits.
_OUT1 = np.empty((2, _NSTATES), np.uint8)
_OUT2 = np.empty((2, _NSTATES), np.uint8)
_NEXT = np.empty((2, _NSTATES), np.uint32)
for _u in (0, 1):
    _r = (_STATES << 1) | _u                 # 7-bit window, newest = LSB...
    # define window bits w6..w0 with w0 = newest input; polynomial taps
    # applied MSB-first: G & window
    _OUT1[_u] = _parity(_r & _G1)
    _OUT2[_u] = _parity(_r & _G2)
    _NEXT[_u] = _r & (_NSTATES - 1) | 0      # drop oldest bit
    _NEXT[_u] = ((_STATES << 1) | _u) & (_NSTATES - 1)


def encode(bits: np.ndarray, invert_g2: bool = True,
           terminate: bool = True) -> np.ndarray:
    """Encode 0/1 bits -> interleaved symbol pairs (2*n [+12 tail]).

    invert_g2: Galileo E1B convention (second branch complemented).
    terminate: append K-1 zero tail bits to flush the register.
    """
    bits = np.asarray(bits, np.int64) & 1
    if terminate:
        bits = np.concatenate([bits, np.zeros(K - 1, np.int64)])
    out = np.empty(2 * bits.size, np.int64)
    s = 0
    for i, u in enumerate(bits):
        o1 = int(_OUT1[u, s])
        o2 = int(_OUT2[u, s])
        if invert_g2:
            o2 ^= 1
        out[2 * i] = o1
        out[2 * i + 1] = o2
        s = int(_NEXT[u, s])
    return out


# predecessor table: state s' -> its two predecessors and the input u
# that led s_prev -> s': s' = ((s_prev << 1) | u) & 63; so
# s_prev in { (s' >> 1), (s' >> 1) | 32 } with u = s' & 1
_SP = np.arange(_NSTATES)
_U_IN = (_SP & 1).astype(np.uint8)
_P0 = _SP >> 1
_P1 = (_SP >> 1) | (_NSTATES >> 1)
_O1_P0 = _OUT1[_U_IN, _P0].astype(np.float64)
_O2_P0 = _OUT2[_U_IN, _P0].astype(np.float64)
_O1_P1 = _OUT1[_U_IN, _P1].astype(np.float64)
_O2_P1 = _OUT2[_U_IN, _P1].astype(np.float64)


def viterbi_decode(symbols: np.ndarray, invert_g2: bool = True,
                   terminated: bool = True) -> np.ndarray:
    """Hard/soft-decision Viterbi decode of interleaved symbol pairs.

    symbols: (2n,) values in [0, 1] (hard 0/1 or soft probabilities of a
    '1'). Returns the decoded bits (tail stripped when `terminated`).
    """
    return viterbi_decode_batch(
        np.asarray(symbols, np.float64)[None, :], invert_g2=invert_g2,
        terminated=terminated)[0]


def viterbi_decode_batch(symbols: np.ndarray, invert_g2: bool = True,
                         terminated: bool = True) -> np.ndarray:
    """Batched Viterbi over equal-length symbol rows: (B, 2n) -> (B, bits).

    Identical numerics to the single-row decode (same add-compare-select
    tie-breaking), but the 64-state trellis ops run on (B, 64) arrays —
    decoding every Galileo half-page candidate of an interval in one call
    costs a few hundred numpy ops total instead of a few hundred PER
    candidate (the dominant Galileo host-decode cost before r5)."""
    sym = np.asarray(symbols, np.float64)
    nb = sym.shape[0]
    sym = sym.reshape(nb, -1, 2)
    n = sym.shape[1]
    if invert_g2:
        sym = sym.copy()
        sym[:, :, 1] = 1.0 - sym[:, :, 1]

    pm = np.full((nb, _NSTATES), 1e9)
    pm[:, 0] = 0.0
    prev = np.empty((n, nb, _NSTATES), np.uint8)  # chosen predecessor

    for i in range(n):
        r1 = sym[:, i, 0][:, None]
        r2 = sym[:, i, 1][:, None]
        cand0 = pm[:, _P0] + (r1 - _O1_P0) ** 2 + (r2 - _O2_P0) ** 2
        cand1 = pm[:, _P1] + (r1 - _O1_P1) ** 2 + (r2 - _O2_P1) ** 2
        take1 = cand1 < cand0
        pm = np.where(take1, cand1, cand0)
        prev[i] = take1
    # traceback from state 0 when terminated, else best state
    s = (np.zeros(nb, np.int64) if terminated
         else pm.argmin(axis=-1).astype(np.int64))
    bits = np.empty((nb, n), np.int64)
    rows = np.arange(nb)
    half = _NSTATES >> 1
    for i in range(n - 1, -1, -1):
        bits[:, i] = s & 1
        s = (s >> 1) | np.where(prev[i, rows, s].astype(bool), half, 0)
    if terminated:
        bits = bits[:, : n - (K - 1)]
    return bits
