"""I/Q container ops: uint8 ingest, normalization, framing.

The reference uses three distinct normalization conventions for RTL-SDR uint8
interleaved I/Q bytes; all three are provided here, with `uint8_to_complex`
(centered, unscaled) as the canonical detector-path convention:

- centered   : x - 127.5              (worker.py:222, triangulateTDOA.py:34)
- normalized : (x - 127.5) / 127.5    (triangulateRSSI.py:30, widmo_plot.py:39)
- int8       : (int8)(x - 128)        (sdrrcv.c:104-106, receiver path)

All ops are jit-friendly (static shapes), operate on device arrays, and batch
over leading dimensions.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def bytes_to_iq_f32(raw: jax.Array, *, centered: bool = True,
                    scale: float | None = None) -> jax.Array:
    """uint8 interleaved I/Q -> complex64.

    Args:
      raw: uint8 array, last dim = 2*n_samples (interleaved I,Q).
      centered: subtract 127.5 (RTL-SDR zero offset).
      scale: optional divisor (127.5 for the [-1,1] convention).

    Returns complex64 array with last dim n_samples.
    """
    x = raw.astype(jnp.float32)
    if centered:
        x = x - 127.5
    if scale is not None:
        x = x / scale
    i = x[..., 0::2]
    q = x[..., 1::2]
    return jax.lax.complex(i, q)


def uint8_to_complex(raw: jax.Array) -> jax.Array:
    """Canonical ingest: x - 127.5, unscaled (detector/TDOA convention)."""
    return bytes_to_iq_f32(raw, centered=True, scale=None)


def uint8_to_complex_normalized(raw: jax.Array) -> jax.Array:
    """(x - 127.5)/127.5 in [-1, 1] (RSSI/spectral convention)."""
    return bytes_to_iq_f32(raw, centered=True, scale=127.5)


def uint8_to_int8(raw: jax.Array) -> jax.Array:
    """Receiver-path convention of `sdrrcv.c:104-106`: uint8 - 128 -> int8.

    Kept in integer domain so the correlator can run int arithmetic.
    """
    return (raw.astype(jnp.int32) - 128).astype(jnp.int8)


def int8_interleaved_to_complex(x8: jax.Array) -> jax.Array:
    """Interleaved int8 I/Q -> complex64."""
    x = x8.astype(jnp.float32)
    return jax.lax.complex(x[..., 0::2], x[..., 1::2])


def uint8_np_to_int8(raw: np.ndarray) -> np.ndarray:
    """Host edge conversion: RTL-SDR uint8 bytes -> int8 (x - 128), zero-copy
    via XOR of the sign bit; this is the only byte-domain work left on the
    host.
    """
    return (raw ^ 0x80).view(np.int8)


_DEINT_ROW = 256                 # bytes per row of the matmul deinterleave


@functools.lru_cache(maxsize=1)
def _deinterleave_mats() -> tuple[np.ndarray, np.ndarray]:
    """0/1 selection matrices: even bytes -> I lanes, odd bytes -> Q lanes."""
    si = np.zeros((_DEINT_ROW, _DEINT_ROW // 2), np.float32)
    sq = np.zeros((_DEINT_ROW, _DEINT_ROW // 2), np.float32)
    k = np.arange(_DEINT_ROW // 2)
    si[2 * k, k] = 1.0
    sq[2 * k + 1, k] = 1.0
    return si, sq


def int8_to_planar(x8: jax.Array, *, convention: str = "centered"):
    """Device ingest: interleaved int8 I/Q -> planar CArray (re, im) f32.

    convention:
      'centered'   : value + 0.5  == uint8 - 127.5  (detector/TDOA path)
      'normalized' : (value + 0.5)/127.5            (RSSI/spectral path)
      'int8'       : value                          (receiver path, sdrrcv.c)
    """
    from . import cplx
    if convention not in ("centered", "normalized", "int8"):
        raise ValueError(f"unknown convention {convention!r}")
    n = x8.shape[-1] // 2
    if x8.shape[-1] % _DEINT_ROW == 0:
        # matmul deinterleave: cast to f32, reshape to 256-byte rows, and
        # split even/odd lanes by two 0/1 selection matmuls. Exact (int8
        # values and single-term sums are exact even in bf16 or TF32).
        # Chosen for an earlier accelerator's matrix unit; not measured on
        # H100.
        si, sq = _deinterleave_mats()
        rows = x8.astype(jnp.float32).reshape(
            x8.shape[:-1] + (x8.shape[-1] // _DEINT_ROW, _DEINT_ROW))
        re = jnp.dot(rows, jnp.asarray(si),
                     preferred_element_type=jnp.float32)
        im = jnp.dot(rows, jnp.asarray(sq),
                     preferred_element_type=jnp.float32)
        re = re.reshape(x8.shape[:-1] + (n,))
        im = im.reshape(x8.shape[:-1] + (n,))
    else:
        # Fallback for sizes that don't fill 256-byte rows: bitcast adjacent
        # (I, Q) byte pairs to int16 lanes and extract the low/high bytes
        # with arithmetic shifts (little-endian: low byte = I), avoiding
        # int8 strided gathers.
        pairs = x8.reshape(x8.shape[:-1] + (n, 2))
        v = jax.lax.bitcast_convert_type(pairs, jnp.int16)
        eight = jnp.int16(8)
        lo = jax.lax.shift_right_arithmetic(
            jax.lax.shift_left(v, eight), eight)
        hi = jax.lax.shift_right_arithmetic(v, eight)
        re = lo.astype(jnp.float32)
        im = hi.astype(jnp.float32)
    if convention == "centered":
        re, im = re + 0.5, im + 0.5
    elif convention == "normalized":
        re, im = (re + 0.5) / 127.5, (im + 0.5) / 127.5
    return cplx.CArray(re, im)


def remove_dc(iq: jax.Array, axis: int = -1) -> jax.Array:
    """Per-block DC removal (widmo_plot.py:44)."""
    return iq - jnp.mean(iq, axis=axis, keepdims=True)


def frame(x: jax.Array, frame_len: int, hop: int) -> jax.Array:
    """Split the last axis into overlapping frames.

    Output shape: (..., n_frames, frame_len) with
    n_frames = 1 + (n - frame_len)//hop. Tail samples that do not fill a
    frame are dropped (XLA needs static shapes; callers pad upstream).
    """
    n = x.shape[-1]
    n_frames = 1 + (n - frame_len) // hop
    if frame_len % hop == 0:
        # Gather-free path: build the overlapped frames from
        # `r = frame_len//hop` static slices of the hop-reshaped signal
        # (frames[i] = concat(b2d[i], ..., b2d[i+r-1])). Chosen where
        # gathers serialized; not measured on H100.
        r = frame_len // hop
        b2d = x[..., : (n // hop) * hop].reshape(
            x.shape[:-1] + (n // hop, hop))
        parts = [jax.lax.slice_in_dim(b2d, i, i + n_frames, axis=-2)
                 for i in range(r)]
        return jnp.concatenate(parts, axis=-1)
    idx = (jnp.arange(n_frames)[:, None] * hop) + jnp.arange(frame_len)[None, :]
    return jnp.take(x, idx, axis=-1)


def frame_nonoverlap(x: jax.Array, frame_len: int) -> jax.Array:
    """Reshape the last axis into consecutive non-overlapping frames."""
    n = x.shape[-1]
    n_frames = n // frame_len
    return x[..., : n_frames * frame_len].reshape(
        x.shape[:-1] + (n_frames, frame_len))


def pad_to_multiple(x: jax.Array, multiple: int, axis: int = -1,
                    value: float = 0.0) -> jax.Array:
    """Right-pad `axis` so its length is a multiple of `multiple`."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths, constant_values=value)


def read_iq_file(path: str, *, convention: str = "centered",
                 count: int = -1, offset_bytes: int = 0) -> np.ndarray:
    """Host-side ingest of a .bin capture -> numpy complex64.

    convention: 'centered' (x-127.5), 'normalized' ((x-127.5)/127.5),
    'int8' ((x-128) as float).
    """
    raw = np.fromfile(path, dtype=np.uint8, count=count, offset=offset_bytes)
    if raw.size % 2:
        raw = raw[:-1]
    f = raw.astype(np.float32)
    if convention == "centered":
        f = f - 127.5
    elif convention == "normalized":
        f = (f - 127.5) / 127.5
    elif convention == "int8":
        f = (raw.astype(np.int16) - 128).astype(np.float32)
    else:
        raise ValueError(f"unknown convention {convention!r}")
    return (f[0::2] + 1j * f[1::2]).astype(np.complex64)


def write_iq_file(path: str, iq_float: np.ndarray) -> None:
    """Write centered float I/Q back to RTL-SDR uint8 format.

    Inverse of the 'centered' convention with the reference's clip-and-offset
    contract (`add_jammer_and_mix.py:177-180`): clip to [-128, 127], +128.
    """
    inter = np.empty(iq_float.size * 2, dtype=np.float32)
    inter[0::2] = np.real(iq_float)
    inter[1::2] = np.imag(iq_float)
    clipped = np.clip(inter, -128.0, 127.0)
    (clipped.astype(np.int16) + 128).astype(np.uint8).tofile(path)
