"""Planar complex arrays: (re, im) float32 plane pairs as a pytree.

The canonical on-device format of complex baseband is a `CArray`
NamedTuple of two float32 planes. Every hot-path op has a planar core;
`complex64` appears at the FFT calls (ops.fftcore) and at the host/API
boundary (tests, NumPy oracles, file I/O). The planar layout was chosen
for an earlier accelerator without a complex dtype; whether it pays on
the H100 is not measured.

This replaces the interleaved int16 I/Q layout of the reference's C kernels
(`sdrcmn.c:581-705` mixcarr, `cpxcpx` sdrcmn.c:102) with contiguous planes
that feed real contractions with float32 accumulation.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class CArray(NamedTuple):
    """Planar complex: two same-shaped float32 arrays. Registered as a
    pytree automatically (NamedTuple), so it passes through jit/vmap/scan."""
    re: jax.Array
    im: jax.Array

    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    def __add__(self, other: "CArray") -> "CArray":
        return CArray(self.re + other.re, self.im + other.im)

    def __sub__(self, other: "CArray") -> "CArray":
        return CArray(self.re - other.re, self.im - other.im)

    def __getitem__(self, idx) -> "CArray":
        return CArray(self.re[idx], self.im[idx])

    def reshape(self, *shape) -> "CArray":
        return CArray(self.re.reshape(*shape), self.im.reshape(*shape))

    def astype(self, dtype) -> "CArray":
        return CArray(self.re.astype(dtype), self.im.astype(dtype))


def from_complex(x) -> CArray:
    """complex array (jax or numpy) -> CArray of float32 planes.

    numpy inputs split on the HOST, which skips uploading the complex
    intermediate.
    """
    if isinstance(x, CArray):
        return x
    if isinstance(x, np.ndarray):
        return CArray(jnp.asarray(np.real(x).astype(np.float32)),
                      jnp.asarray(np.imag(x).astype(np.float32)))
    return CArray(jnp.real(x).astype(jnp.float32),
                  jnp.imag(x).astype(jnp.float32))

def from_np(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """numpy complex -> host (re, im) float32 pair (for jit constants)."""
    return (np.ascontiguousarray(np.real(x), dtype=np.float32),
            np.ascontiguousarray(np.imag(x), dtype=np.float32))


def to_complex(x: CArray) -> jax.Array:
    """CArray -> complex64."""
    return jax.lax.complex(x.re, x.im)


def asarray(x) -> CArray:
    """Coerce complex/np/CArray input to CArray (numpy splits host-side)."""
    if isinstance(x, CArray):
        return x
    if isinstance(x, np.ndarray) and np.iscomplexobj(x):
        return from_complex(x)
    arr = jnp.asarray(x)
    if jnp.iscomplexobj(arr):
        return from_complex(arr)
    return CArray(arr.astype(jnp.float32), jnp.zeros_like(arr, jnp.float32))


def mul(a: CArray, b: CArray) -> CArray:
    """Elementwise complex multiply (broadcasts)."""
    return CArray(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def mul_conj(a: CArray, b: CArray) -> CArray:
    """a * conj(b) elementwise (broadcasts)."""
    return CArray(a.re * b.re + a.im * b.im, a.im * b.re - a.re * b.im)


def conj(a: CArray) -> CArray:
    return CArray(a.re, -a.im)


def scale(a: CArray, s) -> CArray:
    return CArray(a.re * s, a.im * s)


def abs2(a: CArray) -> jax.Array:
    """|a|^2 -> real float32."""
    return a.re * a.re + a.im * a.im


def expi(theta: jax.Array) -> CArray:
    """e^{i theta} as a CArray (the NCO phasor of mixcarr, sdrcmn.c:581)."""
    return CArray(jnp.cos(theta), jnp.sin(theta))


def apply(fn, a: CArray) -> CArray:
    """Apply the same real-array transform to both planes (frame/slice/pad)."""
    return CArray(fn(a.re), fn(a.im))


def zeros(shape, dtype=jnp.float32) -> CArray:
    return CArray(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))


def stack(arrays, axis=0) -> CArray:
    return CArray(jnp.stack([a.re for a in arrays], axis),
                  jnp.stack([a.im for a in arrays], axis))


def sum(a: CArray, axis=None, keepdims=False) -> CArray:  # noqa: A001
    return CArray(jnp.sum(a.re, axis=axis, keepdims=keepdims),
                  jnp.sum(a.im, axis=axis, keepdims=keepdims))


def mean(a: CArray, axis=None, keepdims=False) -> CArray:
    return CArray(jnp.mean(a.re, axis=axis, keepdims=keepdims),
                  jnp.mean(a.im, axis=axis, keepdims=keepdims))
