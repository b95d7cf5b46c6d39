"""Welch PSD parity vs scipy.signal.welch (widmo_plot.py:48 contract)."""
import numpy as np
import jax.numpy as jnp
import pytest
from scipy import signal as ss

from gps_jamming_tpu.ops import cplx, spectral


def test_welch_matches_scipy(rng):
    fs = 2.048e6
    n = 1 << 15
    t = np.arange(n) / fs
    x = (np.exp(2j * np.pi * 100e3 * t)
         + 0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    want_f, want = ss.welch(x, fs, nperseg=1024, return_onesided=False)
    got = np.asarray(spectral.welch_psd(jnp.asarray(x), fs, nperseg=1024))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-12)


@pytest.mark.parametrize("n", [1 << 17, 100_000, 16_384, 131_772])
def test_welch_planar_matches_scipy_at_block_sizes(n, rng):
    """welch_psd_p on noise at the sizes the detect chain frames, including
    lengths that leave a partial last segment."""
    fs = 2.048e6
    x = (rng.standard_normal(n)
         + 1j * rng.standard_normal(n)).astype(np.complex64)
    _, want = ss.welch(x.astype(np.complex128), fs, nperseg=1024,
                       return_onesided=False)
    got = np.asarray(spectral.welch_psd_p(cplx.asarray(jnp.asarray(x)), fs,
                                          1024))
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_psd_db_shifted_matches_reference_chain(rng):
    fs = 2.048e6
    n = 1 << 14
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    _, pxx = ss.welch(x, fs, nperseg=1024, return_onesided=False)
    want = 10 * np.log10(np.fft.fftshift(pxx) + 1e-15)
    got = np.asarray(spectral.psd_db_shifted(
        spectral.welch_psd(jnp.asarray(x), fs, nperseg=1024)))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_spectrogram_shape_and_tone_peak(rng):
    fs = 2.048e6
    chunk = 1 << 16
    n = 4 * chunk
    t = np.arange(n) / fs
    tone = 300e3
    x = (np.exp(2j * np.pi * tone * t)
         + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    sg = np.asarray(spectral.spectrogram(jnp.asarray(x), fs, chunk, nperseg=1024))
    assert sg.shape == (4, 1024)
    freqs = spectral.freq_axis_mhz(fs, 1024)
    peak_mhz = freqs[np.argmax(sg[0])]
    assert abs(peak_mhz - tone / 1e6) < 0.01


def test_spectrogram_file_matches_in_memory(tmp_path):
    """The streamed file waterfall equals the in-memory spectrogram
    row for row (chunk granularity makes batch boundaries invisible)."""
    import jax.numpy as jnp

    from gps_jamming_tpu.ops import iq as iq_ops
    from gps_jamming_tpu.ops import spectral

    rng = np.random.default_rng(3)
    fs = 65536.0
    n = int(5.5 * fs)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 20.0
    path = str(tmp_path / "cap.bin")
    iq_ops.write_iq_file(path, x.astype(np.complex64))

    xn = iq_ops.read_iq_file(path, convention="normalized")
    chunk = int(fs)
    want = np.asarray(spectral.spectrogram(jnp.asarray(xn), fs, chunk, 256))
    got = spectral.spectrogram_file(path, fs, chunk, 256, batch_chunks=2)
    assert got.shape == want.shape == (5, 256)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
