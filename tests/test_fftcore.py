"""fftcore (the jnp.fft path every DFT takes) vs the numpy oracle.

Every size the framework uses must match np.fft to float32 tolerance,
through both the complex64 and the planar entry points.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from gps_jamming_tpu.ops import cplx, fftcore


def _fft(x, n=None):
    """Planar FFT of a complex numpy array, back to complex."""
    y = fftcore.fft_p(cplx.asarray(jnp.asarray(x)), n=n)
    return np.asarray(y.re) + 1j * np.asarray(y.im)


def _ifft(x):
    y = fftcore.ifft_p(cplx.asarray(jnp.asarray(x)))
    return np.asarray(y.re) + 1j * np.asarray(y.im)


def _rand_c(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


@pytest.mark.parametrize("n", [64, 1000, 1024, 2048])
def test_single_stage_matches_numpy(rng, n):
    x = _rand_c(rng, n)
    got = _fft(x)
    want = np.fft.fft(x)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-2 * np.sqrt(n))


@pytest.mark.parametrize("n", [4096, 50000, 131072])
def test_two_stage_matches_numpy(rng, n):
    x = _rand_c(rng, n)
    got = _fft(x)
    want = np.fft.fft(x)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-4)


def test_ifft_roundtrip(rng):
    for n in (1024, 8192):
        x = _rand_c(rng, n)
        back = _ifft(_fft(x))
        np.testing.assert_allclose(back, x, atol=1e-3)


def test_batched(rng):
    x = _rand_c(rng, 3, 5, 512)
    got = _fft(x)
    want = np.fft.fft(x, axis=-1)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=0.3)


def test_padding_arg(rng):
    x = _rand_c(rng, 300)
    got = _fft(x, n=512)
    want = np.fft.fft(x, n=512)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=0.2)


def test_fft_power(rng):
    x = _rand_c(rng, 7, 1024)
    got = np.asarray(fftcore.fft_power_p(cplx.asarray(jnp.asarray(x))))
    want = np.abs(np.fft.fft(x, axis=-1)) ** 2
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1.0)


def test_ops_parity_through_fftcore(rng):
    """Welch PSD and xcorr stay scipy-accurate through fftcore."""
    from scipy import signal as ss
    from gps_jamming_tpu.ops import corr, spectral
    fs = 2.048e6
    n = 1 << 14
    x = _rand_c(rng, n)
    got = np.asarray(spectral.welch_psd(jnp.asarray(x), fs, nperseg=1024))
    _, want = ss.welch(x, fs, nperseg=1024, return_onesided=False)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-9)

    a = _rand_c(rng, 2000)
    true_lag = 57
    b = np.roll(a, -true_lag)
    lag, _ = corr.xcorr_peak_lag(jnp.asarray(a), jnp.asarray(b), subsample=False)
    assert int(lag) == true_lag


@pytest.mark.parametrize("fn,oracle", [
    ("fft_p", lambda x: np.fft.fft(x, axis=-1)),
    ("ifft_p", lambda x: np.fft.ifft(x, axis=-1)),
    ("fft_power_p", lambda x: np.abs(np.fft.fft(x, axis=-1)) ** 2),
    ("ifft_power_p", lambda x: np.abs(np.fft.ifft(x, axis=-1)) ** 2),
])
def test_planar_api_matches_numpy(rng, fn, oracle):
    """The planar entry points every device kernel calls."""
    x = _rand_c(rng, 4, 2048)
    got = getattr(fftcore, fn)(cplx.asarray(jnp.asarray(x)))
    if isinstance(got, cplx.CArray):
        got = np.asarray(got.re) + 1j * np.asarray(got.im)
    want = oracle(x.astype(np.complex128))
    scale = np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               atol=1e-5)

