"""FFT entry points for planar (CArray) complex arrays.

Every DFT of the device code goes through here, so the transform backend
is one decision in one module: `jnp.fft`, which XLA lowers to cuFFT on the
GPU and to its own FFT on the CPU. The functions take and return
`cplx.CArray` (re, im) float32 planes, the layout the device code carries.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import cplx


def fft_p(x: cplx.CArray, n: int | None = None) -> cplx.CArray:
    """DFT over the last axis of a planar complex array."""
    y = jnp.fft.fft(cplx.to_complex(x), n=n, axis=-1)
    return cplx.from_complex(y)


def ifft_p(x: cplx.CArray, n: int | None = None) -> cplx.CArray:
    y = jnp.fft.ifft(cplx.to_complex(x), n=n, axis=-1)
    return cplx.from_complex(y)


def fft_power_p(x: cplx.CArray, n: int | None = None) -> jax.Array:
    """|FFT(x)|^2 from planes, squaring the (re, im) pair directly."""
    y = fft_p(x, n=n)
    return y.re * y.re + y.im * y.im


def ifft_power_p(x: cplx.CArray) -> jax.Array:
    """|IFFT(x)|^2 from planes."""
    y = ifft_p(x)
    return y.re * y.re + y.im * y.im
