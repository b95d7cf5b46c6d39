"""Acquisition kernels (XLA path) against the float64 NumPy twins.

`ops.reference` evaluates each search surface the direct way, one Doppler
row at a time in float64; the device kernels factorize it (replica-spectrum
shifts, cross-block fine DFTs, coherent groups). Both must agree to float32
accuracy over the block counts, group splits and padding cases the
receivers use, and `acquisition_test` must reproduce `checkacquisition`.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from gps_jamming_tpu.config import AcquisitionConfig
from gps_jamming_tpu.models.receiver import acquisition as acq_mod
from gps_jamming_tpu.models.receiver import glonass as glo
from gps_jamming_tpu.ops import caf, cplx, corr
from gps_jamming_tpu.ops import reference as R

FS = 2.048e6
TOL = 2e-6                        # max|d| / max(ref), float32 vs float64


def _planes(rng, shape, scale=1.0):
    return cplx.CArray(
        jnp.asarray((scale * rng.standard_normal(shape)).astype(np.float32)),
        jnp.asarray((scale * rng.standard_normal(shape)).astype(np.float32)))


def _host_replica(rng, n_prn, n):
    return cplx.CArray(rng.standard_normal((n_prn, n)).astype(np.float32),
                       rng.standard_normal((n_prn, n)).astype(np.float32))


def _rel_err(got, want):
    return float(np.max(np.abs(np.asarray(got) - want)) / np.max(want))


@pytest.mark.parametrize("n,n_blocks,n_prn,n_freq", [
    (256, 3, 4, 5),       # odd block count, Doppler grid wider than a tile
    (256, 2, 3, 5),       # padding-sized PRN / Doppler counts
    (256, 2, 3, 3),
    (8192, 1, 3, 2),      # long block, single integration
    (2048, 10, 8, 3),     # GPS block length, reference ACQINTG
    (1000, 4, 2, 9),      # non-power-of-two block
])
def test_caf_accumulate_matches_float64(n, n_blocks, n_prn, n_freq):
    rng = np.random.default_rng(n + n_blocks)
    x = _planes(rng, (n_blocks, n))
    rep = _host_replica(rng, n_prn, n)
    freqs = caf.doppler_bins(2000.0, 500.0)[:n_freq]
    got = caf.caf_accumulate(x, rep, freqs, FS)
    want = R.caf_accumulate_np(x, rep, freqs, FS)
    assert got.shape == want.shape == (n_prn, n_freq, n)
    assert _rel_err(got, want) < TOL


@pytest.mark.parametrize("n,n_blocks,n_groups,n_prn", [
    (2048, 10, 2, 4),     # the GPS search: 5 ms coherent groups
    (2048, 4, 2, 32),     # all 32 replicas, short integration
    (2048, 10, 5, 3),     # 2 ms groups
    (1024, 6, 3, 2),
    (2048, 8, 4, 3),
    (4096, 4, 1, 2),      # one coherent group
])
def test_caf_accumulate_pcf_matches_float64(n, n_blocks, n_groups, n_prn):
    rng = np.random.default_rng(n_blocks * 7 + n_groups)
    x = _planes(rng, (n_blocks, n))
    rep = _host_replica(rng, n_prn, n)
    got = caf.caf_accumulate_pcf(x, rep, FS, n_groups=n_groups)
    want = R.caf_accumulate_pcf_np(x, rep, FS, n_groups=n_groups)
    rows = caf.pcf_doppler_hz(FS, n, 7000.0).size
    assert got.shape == want.shape == (n_prn, rows, n)
    assert _rel_err(got, want) < TOL


def test_caf_accumulate_pcf_rejects_split_groups():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="not divisible"):
        caf.caf_accumulate_pcf(_planes(rng, (5, 256)),
                               _host_replica(rng, 1, 256), FS, n_groups=2)


@pytest.mark.parametrize("n_blocks,n_groups,channels", [
    (4, 2, (-7, 0, 6)),        # band edges and centre
    (10, 2, (-2, -1, 0, 1, 2)),
    (6, 3, (3,)),
    (4, 1, (-5, 5)),
])
def test_caf_accumulate_pcf_fdma_matches_float64(n_blocks, n_groups,
                                                 channels):
    fs, n = 10e6, 10000
    rng = np.random.default_rng(n_blocks + len(channels))
    x = _planes(rng, (n_blocks, n))
    rep = glo.replica_table_host(fs, n)
    offs = glo.channel_offsets_hz(channels=channels)
    got = caf.caf_accumulate_pcf_fdma(x, rep, offs, fs, n_groups=n_groups)
    want = R.caf_accumulate_pcf_fdma_np(x, rep, offs, fs,
                                        n_groups=n_groups)
    assert got.shape == want.shape == (len(channels), 90, n)
    assert _rel_err(got, want) < TOL


def _buried_code_surface(seed, n=2048, n_prn=4, lag=517, prn=2,
                         doppler=1500.0, noise=2.0):
    """CAF search of blocks that carry code `prn` at (lag, doppler)."""
    rng = np.random.default_rng(seed)
    chips = np.sign(rng.standard_normal((n_prn, n)))
    rep_c = np.conj(np.fft.fft(chips, axis=-1))
    rep = cplx.CArray(rep_c.real.astype(np.float32),
                      rep_c.imag.astype(np.float32))
    t = np.arange(n) / FS
    sig = np.roll(chips[prn], lag) * np.exp(2j * np.pi * doppler * t)
    blocks = sig + noise * (rng.standard_normal((4, n))
                            + 1j * rng.standard_normal((4, n)))
    freqs = caf.doppler_bins(3000.0, 500.0)
    x = cplx.CArray(jnp.asarray(blocks.real.astype(np.float32)),
                    jnp.asarray(blocks.imag.astype(np.float32)))
    return np.asarray(caf.caf_accumulate(x, rep, freqs, FS)), freqs


@pytest.mark.parametrize("seed,exclude_chips", [
    (0, 2.0), (1, 2.0), (2, 1.0), (3, 4.0), (4, 0.5), (5, 2.0)])
def test_acquisition_test_matches_checkacquisition_twin(seed,
                                                        exclude_chips):
    surf, freqs = _buried_code_surface(seed)
    cfg = AcquisitionConfig(exclude_chips=exclude_chips)
    got = acq_mod.acquisition_test(jnp.asarray(surf), jnp.asarray(freqs),
                                   FS, cfg, 1e-3)
    want = R.checkacquisition_np(surf, freqs, cfg.peak_ratio_threshold,
                                 exclude_chips, 1e-3)
    np.testing.assert_array_equal(np.asarray(got.acquired),
                                  want["acquired"])
    np.testing.assert_array_equal(np.asarray(got.code_phase),
                                  want["code_phase"])
    np.testing.assert_array_equal(np.asarray(got.doppler_hz),
                                  want["doppler_hz"])
    np.testing.assert_allclose(np.asarray(got.peak_power), want["peak"],
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got.peak_ratio),
                               want["peak_ratio"], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got.cn0_dbhz), want["cn0_dbhz"],
                               rtol=1e-5)
    # the buried code is found where it was put, the others are not
    assert bool(got.acquired[2]) and int(got.code_phase[2]) == 517
    assert float(got.doppler_hz[2]) == 1500.0
    assert not np.asarray(got.acquired)[[0, 1, 3]].any()


def test_excluded_statistics_match_twin():
    """Second peak and mean over the peak row outside the +/- window."""
    surf, freqs = _buried_code_surface(7)
    want = R.checkacquisition_np(surf, freqs, 3.0, 2.0, 1e-3)
    rows = jnp.asarray(surf[np.arange(4), want["doppler_index"]])
    pk = jnp.asarray(want["code_phase"])
    excl = 2 * 2                            # 2 chips at 2 samples/chip
    np.testing.assert_allclose(
        np.asarray(corr.second_peak_excluded(rows, pk, excl)),
        want["second"], rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(corr.mean_excluded(rows, pk, excl)), want["mean"],
        rtol=1e-5)


def test_pcf_doppler_grid():
    d = caf.pcf_doppler_hz(FS, 2048, 7000.0)
    assert d.size == 15 * 2 * 3
    assert d.min() == -7200.0 and d.max() == 7700.0
    assert np.all(np.diff(d) > 0)
    # every |f| <= 7000 is within 150 Hz of a grid point (interior: 50 Hz)
    probe = np.linspace(-7000, 7000, 281)
    dist = np.abs(probe[:, None] - d[None, :]).min(axis=1)
    assert dist.max() <= 150.0
    assert np.median(dist) <= 50.0


@pytest.mark.parametrize("fs,n,n_coarse", [
    (2.048e6, 2048, 15),      # GPS: 1 kHz bins
    (10e6, 10000, 15),        # GLONASS: 1 kHz bins
    (4.096e6, 16384, 57),     # Galileo E1B: 250 Hz bins
])
def test_pcf_doppler_grid_sizes(fs, n, n_coarse):
    d = caf.pcf_doppler_hz(fs, n, 7000.0)
    assert d.size == n_coarse * 2 * 3
    bin_hz = fs / n
    coarse = d.reshape(n_coarse, 2, 3)[:, 0, 1]
    np.testing.assert_allclose(np.diff(coarse), bin_hz)
    assert coarse[n_coarse // 2] == 0.0


@pytest.mark.parametrize("n,fs,n_blocks,expect", [
    (2048, 2.048e6, 10, True),      # GPS: 180 PCF rows vs 710
    (16384, 4.096e6, 4, False),     # Galileo, 4 blocks: 684 vs 284
    (16384, 4.096e6, 10, True),     # Galileo, 10 blocks: 684 vs 710
])
def test_pcf_profitable(n, fs, n_blocks, expect):
    assert caf.pcf_profitable(n, n_blocks, fs, 7000.0, 71) is expect
