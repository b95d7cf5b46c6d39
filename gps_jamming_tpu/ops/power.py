"""Chunked power estimation and threshold detection primitives.

Batched replacement for the reference's host loops:
- power pre-scan `worker.py:198-275` (32768-sample chunks, mean I^2+Q^2,
  5th-percentile baseline, +6 dB ITU-R threshold, contiguous range extract),
- standalone detector `checkIfJamming.py:7-67` (131072-byte chunks vs a fixed
  threshold),
- TDOA onset finder `triangulateTDOA.py:37-49` (noise floor from leading
  samples, moving-average power, 50x threshold).

Everything here is pure jnp on static shapes so it fuses under jit; the
variable-length "ranges" extraction returns a boolean mask plus padded
start/end indices (XLA-friendly) with a host-side helper to densify.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import cplx
from .iq import frame_nonoverlap


def chunk_power(iq: jax.Array, chunk_samples: int) -> jax.Array:
    """Mean |IQ|^2 per non-overlapping chunk.  (worker.py:220-230)

    Matches the reference contract: mean(I^2 + Q^2) + 1e-10 per chunk,
    INCLUDING the final partial chunk (the reference's read loop computes the
    mean of whatever the last read returned, worker.py:217-230).
    Input: complex64 (..., n); output: float32 (..., ceil(n/chunk_samples)).
    """
    return chunk_power_p(cplx.asarray(iq), chunk_samples)


def chunk_power_p(x: cplx.CArray, chunk_samples: int) -> jax.Array:
    """Planar chunk-power core (the device path)."""
    power = cplx.abs2(x)
    n = power.shape[-1]
    n_full = n // chunk_samples
    out = []
    if n_full:
        frames = frame_nonoverlap(power[..., : n_full * chunk_samples],
                                  chunk_samples)
        out.append(jnp.mean(frames, axis=-1))
    if n % chunk_samples:
        tail = power[..., n_full * chunk_samples:]
        out.append(jnp.mean(tail, axis=-1, keepdims=True))
    p = out[0] if len(out) == 1 else jnp.concatenate(out, axis=-1)
    return p + 1e-10


def chunk_power_streaming_init(chunk_samples: int) -> tuple:
    """Carry init for streaming power accumulation over blocks."""
    del chunk_samples
    return ()


def power_baseline(power_map: jax.Array, percentile: float = 5.0) -> jax.Array:
    """Noise-floor baseline = percentile of the chunk powers (worker.py:242).

    Uses linear-interpolation percentile to match np.percentile.
    """
    base = jnp.percentile(power_map, percentile)
    # worker.py:243 clamps a non-positive baseline to 1.0
    return jnp.where(base <= 0, 1.0, base)


def power_threshold_linear(baseline: jax.Array, rise_db: float) -> jax.Array:
    """baseline * 10^(rise_db/10)  (worker.py:245-246)."""
    return baseline * 10.0 ** (rise_db / 10.0)


def above_threshold_mask(power_map: jax.Array, threshold: jax.Array) -> jax.Array:
    return power_map > threshold


def mask_to_edges(mask: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Rising/falling edge flags of a boolean run-mask.

    Mirrors the diff-based range extraction of worker.py:253-259:
    starts[i] True where a run begins at chunk i, ends[i] True where a run
    ends *before* chunk i (exclusive end), with boundary handling.
    """
    m = mask.astype(jnp.int32)
    prev = jnp.concatenate([jnp.zeros_like(m[..., :1]), m[..., :-1]], axis=-1)
    nxt = jnp.concatenate([m[..., 1:], jnp.zeros_like(m[..., :1])], axis=-1)
    starts = (m == 1) & (prev == 0)
    ends_at = (m == 1) & (nxt == 0)   # inclusive last chunk of each run
    return starts, ends_at


def extract_ranges(mask: np.ndarray, chunk_size_bytes: int) -> list[tuple[int, int]]:
    """Host-side densification: boolean mask -> [(start_byte, end_byte)).

    Exclusive end, matching worker.py:261-264 (end index = one past the last
    above-threshold chunk, scaled by the chunk byte size).
    """
    mask = np.asarray(mask).astype(bool)
    if mask.size == 0 or not mask.any():
        return []
    d = np.diff(mask.astype(np.int8))
    starts = list(np.where(d == 1)[0] + 1)
    ends = list(np.where(d == -1)[0] + 1)
    if mask[0]:
        starts.insert(0, 0)
    if mask[-1]:
        ends.append(mask.size)
    return [(int(s) * chunk_size_bytes, int(e) * chunk_size_bytes)
            for s, e in zip(starts, ends)]


def moving_average(x: jax.Array, window: int) -> jax.Array:
    """'valid' moving average via cumsum (triangulateTDOA.py:43).

    Output length n - window + 1. Uses float64-free cumsum; for very long
    windows prefers the FFT path upstream.
    """
    c = jnp.cumsum(jnp.concatenate([jnp.zeros_like(x[..., :1]), x], axis=-1),
                   axis=-1)
    return (c[..., window:] - c[..., :-window]) / window


def find_onset(iq: jax.Array, noise_samples: int, window: int,
               threshold_factor: float) -> jax.Array:
    """Interference onset index (triangulateTDOA.py:37-49).

    noise floor = mean power of the first `noise_samples`; onset = first index
    where the `window`-sample moving average exceeds factor*floor, plus
    window//2 recentring. Returns -1 (int32) when not found.
    """
    power = cplx.abs2(cplx.asarray(iq))
    noise = jnp.mean(power[..., :noise_samples], axis=-1, keepdims=True)
    noise = jnp.where(noise == 0, 1e-9, noise)
    avg = moving_average(power, window)
    above = avg > noise * threshold_factor
    idx = jnp.argmax(above, axis=-1)
    found = jnp.any(above, axis=-1)
    return jnp.where(found, idx + window // 2, -1).astype(jnp.int32)


def find_first_above(amplitude: jax.Array, threshold: float) -> jax.Array:
    """First index with amplitude > threshold (triangulateRSSI.py:37-40).

    Returns -1 when the threshold is never crossed.
    """
    above = amplitude > threshold
    idx = jnp.argmax(above, axis=-1)
    found = jnp.any(above, axis=-1)
    return jnp.where(found, idx, -1).astype(jnp.int32)


def mean_after_onset(x: jax.Array, onset: jax.Array) -> jax.Array:
    """Mean of x[onset:] with a traced onset (masked mean, static shape)."""
    n = x.shape[-1]
    pos = jnp.arange(n)
    m = (pos >= onset[..., None]).astype(x.dtype)
    s = jnp.sum(x * m, axis=-1)
    cnt = jnp.maximum(jnp.sum(m, axis=-1), 1)
    return s / cnt
