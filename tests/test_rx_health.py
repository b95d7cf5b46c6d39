"""Channel health-reset taxonomy + wire-format tests.

The reference frees a channel on FOUR conditions (not just low SNR):
nav-not-decoded after 60 s, stale week, elevation < 12 deg
(sdrmain.c:263-340, thresholds sdr.h:115-121) and observables stale
> 90 s (checkObsDelay, sdrmain.c:464-511). The streaming receiver's
decode-probe rounds implement all four; these tests drive each cause in
isolation with a mocked probe decoder (the decode itself is covered by
the receiver e2e tests).
"""
import dataclasses

import numpy as np
import pytest

from gps_jamming_tpu.models.receiver import lnav
from gps_jamming_tpu.ops import cplx
from gps_jamming_tpu.runtime import rx_stream

FS = 1.024e6                       # 1024-sample C/A period: cheap on CPU


def _eph(week=2400):
    return lnav.Ephemeris(
        prn=5, week=week, toc=345600.0, af0=0.0, af1=0.0, af2=0.0,
        tgd=0.0, iodc=100, ura=1, health=0, iode=100, toe=345600.0,
        sqrt_a=np.sqrt(26_560_000.0), e=0.008, m0=2.0, delta_n=4.5e-9,
        omega0=1.0, omega_dot=-8.0e-9, omega=0.5, i0=0.958, idot=-3e-10,
        cuc=0.0, cus=0.0, crc=0.0, crs=0.0, cic=0.0, cis=0.0,
        have_subframes=(1, 2, 3))


class _FakeObs:
    """Minimal stand-in for ChannelObservables: enough for the health
    probe AND for _decode_pvt's bookkeeping (1-epoch coverage keeps it
    out of every PVT epoch)."""

    def __init__(self, eph):
        self.eph = eph
        self.prn = eph.prn
        self.chips = np.zeros(1)
        self.cn0_dbhz = np.zeros(1)
        self.doppler_hz = np.zeros(1)


def _mk_rx(**kw):
    """Tiny streaming receiver: 2 slots, 0.25 s segments, probe every
    segment, C/N0 reset disabled so the nav-level causes act alone."""
    kw.setdefault("reset_cn0_dbhz", -1e9)
    kw.setdefault("min_cn0_dbhz", -1e9)
    rx = rx_stream.StreamingReceiver(
        FS, system="gps", n_slots=2, segment_s=0.25,
        health_probe_every_s=0.25, **kw)

    # force-assign PRN 5 on the first acquisition attempt
    calls = {"n": 0}

    def fake_acquire(xw, seg_start):
        calls["n"] += 1
        out = np.zeros((5, 32), np.float32)
        out[0, 4] = 1.0            # acquired flag for PRN 5
        out[1, 4] = 100.0          # lag
        out[3, 4] = 5.0            # peak ratio
        out[4, 4] = 45.0           # cn0
        return out

    rx._acquire = fake_acquire
    rx._refine = lambda xw, t2, lags, eff, c2, o2: np.asarray(eff)
    return rx


def _noise(seconds):
    rng = np.random.default_rng(1)
    n = int(seconds * FS)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)


def _span_ends(res):
    return [(sat, a, b) for sat, a, b in res.tracked_spans]


def test_nodecode_reset_frees_ghost_slot():
    """A slot that never decodes nav (ghost correlation peak) is freed
    after reset_nodecode_s — the sdrmain.c:263-340 no-decode branch."""
    rx = _mk_rx(reset_nodecode_s=1.0)
    rx._build_obs = lambda iv, n_use: None
    res = rx.process(_noise(2.0))
    spans = _span_ends(res)
    assert spans, "no tracked spans at all"
    # first interval must END mid-capture (reset), then re-acquire
    assert spans[0][0] == 5
    assert spans[0][2] < res.cn0_epochs.size, spans
    assert len(spans) >= 2, "slot was not re-acquired after the reset"


def test_obs_stale_reset():
    """A slot that decoded once but emits no newer observables for
    reset_obs_stale_s is freed — the checkObsDelay role."""
    rx = _mk_rx(reset_obs_stale_s=1.0, reset_nodecode_s=1e9)
    obs = _FakeObs(_eph())

    def fake_build(iv, n_use):
        return obs if iv.start_epoch + n_use <= 1250 else None

    rx._build_obs = fake_build
    res = rx.process(_noise(3.0))
    spans = _span_ends(res)
    # obs last covered epoch 1250; stale after 1250 + 1000 epochs
    assert spans[0][2] <= 2500, spans
    assert len(spans) >= 2


def test_week_stale_reset():
    """A decoded week below the sdr.h gate (2360 after rollover
    adjustment) frees the slot immediately."""
    rx = _mk_rx(reset_nodecode_s=1e9)
    rx._build_obs = lambda iv, n_use: _FakeObs(_eph(week=100))
    res = rx.process(_noise(2.0))
    spans = _span_ends(res)
    assert spans[0][2] < res.cn0_epochs.size, spans


def test_elevation_reset():
    """Once a PVT fix exists, a satellite below the 12 deg tracking mask
    is freed (sdr.h:115-121)."""
    rx = _mk_rx(reset_nodecode_s=1e9)
    rx._build_obs = lambda iv, n_use: _FakeObs(_eph())
    rx._sat_elevation = lambda obs, local, fix: 5.0

    def seed_fix(done, n_total, snapshot):
        rx._probe_fix = np.array([3.7e6, 1.4e6, 5.0e6])

    res = rx.process(_noise(2.0), segment_cb=seed_fix)
    spans = _span_ends(res)
    assert spans[0][2] < res.cn0_epochs.size, spans


def test_healthy_slot_not_reset():
    """Control: decoding, current-week, high-elevation slot stays
    tracked to EOF."""
    rx = _mk_rx(reset_nodecode_s=1.0, reset_obs_stale_s=1.0)
    rx._build_obs = lambda iv, n_use: _FakeObs(_eph())
    rx._sat_elevation = lambda obs, local, fix: 45.0
    res = rx.process(_noise(2.0))
    spans = _span_ends(res)
    assert len(spans) == 1, spans
    assert spans[0][2] == res.cn0_epochs.size, spans


def test_sat_elevation_geometry():
    """_sat_elevation returns a sane elevation for a real ephemeris seen
    from the earth's surface."""
    rx = rx_stream.StreamingReceiver(FS, system="gps", n_slots=2,
                                     segment_s=0.25)
    from gps_jamming_tpu.models.receiver import observables, pvt
    eph = _eph()
    obs = observables.ChannelObservables(
        prn=5, eph=eph, chips=np.arange(2000.0) * 1023.0,
        anchor_chip=0.0, anchor_tow=eph.toe - 1.0,
        cn0_dbhz=np.full(2000, 45.0), doppler_hz=np.zeros(2000),
        sync_quality=1.0, sample_offset=0.0, epoch_samples=1024)
    fix = pvt.lla_to_ecef(50.0, 20.0, 200.0)
    el = rx._sat_elevation(obs, 1000, np.asarray(fix))
    assert -90.0 <= el <= 90.0
    assert np.isfinite(el)


def test_wire4_pack_unpack_roundtrip():
    """Device unpack of the 4-bit wire format inverts the host LUT pack
    exactly (quantized values, both components, even/odd order)."""
    rx = rx_stream.StreamingReceiver(FS, system="gps", n_slots=2,
                                     segment_s=0.25)
    rng = np.random.default_rng(3)
    v = rng.integers(-128, 128, (2, 4096), dtype=np.int8)
    off, step = 0.5, 4.0
    vals = np.arange(256).astype(np.int8).astype(np.float32) + off
    lut = np.clip(np.round(vals / step), -8, 7).astype(np.int8)
    q = lut[v.view(np.uint8)]
    h = q.shape[1] // 2                 # BLOCK layout: byte j carries
    packed = ((q[:, :h] & 15) | (q[:, h:] << 4)).astype(np.int8)

    import jax.numpy as jnp
    rx._ingest_conv = ("i4", np.float32(step))
    out = rx._ingest(cplx.CArray(jnp.asarray(packed[0]),
                                 jnp.asarray(packed[1])))
    want = q.astype(np.float32) * step
    np.testing.assert_array_equal(np.asarray(out.re), want[0])
    np.testing.assert_array_equal(np.asarray(out.im), want[1])


def test_wire4_default_quantization_loss_small():
    """The +/-2.5 sigma LUT loses <0.2 dB of SNR on a weak-signal-in-
    noise mixture (the classic 4-bit GNSS quantization bound)."""
    rng = np.random.default_rng(4)
    n = 1 << 16
    sig = np.sign(rng.standard_normal(n)) * 1.5        # weak BPSK chips
    noise = rng.normal(0.0, 20.0, n)
    v = np.clip(np.round(sig + noise), -128, 127).astype(np.int8)
    sigma = float(np.std(v.astype(np.float32) + 0.5))
    step = max(2.5 * sigma / 7.0, 0.25)
    vals = np.arange(256).astype(np.int8).astype(np.float32) + 0.5
    lut = np.clip(np.round(vals / step), -8, 7).astype(np.int8)
    q = lut[v.view(np.uint8)].astype(np.float32) * step
    # correlation against the chips: SNR ratio quantized vs full
    c_full = np.dot(v.astype(np.float32) + 0.5, sig)
    c_q = np.dot(q, sig)
    # correlator gain preserved within 0.2 dB
    loss_db = 20.0 * np.log10(abs(c_full) / max(abs(c_q), 1e-9))
    assert abs(loss_db) < 0.2, loss_db


def test_wire2_pack_unpack_roundtrip():
    """Device unpack of the 2-bit wire (four samples/byte, levels
    (2q+1)*delta) inverts the host pack exactly."""
    rx = rx_stream.StreamingReceiver(FS, system="gps", n_slots=2,
                                     segment_s=0.25)
    rng = np.random.default_rng(5)
    v = rng.integers(-128, 128, (2, 4096), dtype=np.int8)
    off, delta = 0.5, 12.0
    vals = np.arange(256).astype(np.int8).astype(np.float32) + off
    lut = np.clip(np.floor(vals / (2.0 * delta)), -2, 1).astype(np.int8)
    q = lut[v.view(np.uint8)]
    qr = q.reshape(2, 4, q.shape[1] // 4)   # BLOCK layout quarters
    packed = ((qr[:, 0] & 3) | ((qr[:, 1] & 3) << 2)
              | ((qr[:, 2] & 3) << 4) | (qr[:, 3] << 6)).astype(np.int8)

    import jax.numpy as jnp
    rx._ingest_conv = ("i2", np.float32(delta))
    out = rx._ingest(cplx.CArray(jnp.asarray(packed[0]),
                                 jnp.asarray(packed[1])))
    want = (2.0 * q.astype(np.float32) + 1.0) * delta
    np.testing.assert_array_equal(np.asarray(out.re), want[0])
    np.testing.assert_array_equal(np.asarray(out.im), want[1])
    # levels are the classic {-3,-1,1,3} * delta set
    assert set(np.unique(want)) <= {-3.0 * delta, -delta, delta,
                                    3.0 * delta}


@pytest.mark.slow
def test_wire4_file_path_still_fixes(tmp_path):
    """process_file with --wire-bits 4 (half the upload bytes) still
    acquires, decodes and fixes on a geometry-true capture — the
    quantization cost stays inside the link margin."""
    import jax

    from gps_jamming_tpu.ops import iq as iq_ops
    from gps_jamming_tpu.sim import constellation
    from tests.test_rx_stream import FS as GFS, RX_LLA, TOE, _shell

    tow0 = TOE - 1.3
    n = int(26.0 * GFS)
    sig, truths, rx_ecef = constellation.simulate_constellation(
        _shell(), RX_LLA, tow0, n, GFS, noise_std=0.3, seed=11)
    path = str(tmp_path / "cap.bin")
    iq_ops.write_iq_file(path, (sig * 12.0).astype(np.complex64))

    rx = rx_stream.StreamingReceiver(GFS, system="gps", segment_s=2.0)
    res = rx.process_file(path, convention="centered", wire_bits=4)
    errs = [np.linalg.norm(f.pos_ecef - rx_ecef)
            for f in res.fixes if f.valid]
    assert errs, "no fixes through the 4-bit wire"
    assert np.median(errs) < 35.0, np.median(errs)


def test_obs_horizon_cleared_on_cn0_reset_and_reassign():
    """Regression: a slot freed by the C/N0 reset and re-acquired must
    NOT inherit the previous occupant's decode horizon — the old
    satellite's last-obs epoch would make the new one instantly
    'obs_stale' before its own nodecode grace."""
    rx = _mk_rx(reset_cn0_dbhz=1e9,        # every aged segment is "bad"
                grace_segments=7,          # ...so ONE reset at ~seg 8
                reset_obs_stale_s=0.25,    # hair-trigger staleness
                reset_nodecode_s=1e9)
    obs = _FakeObs(_eph())
    # first interval (start_epoch 0) decodes -> slot_obs_end set;
    # every re-acquired interval decodes nothing
    rx._build_obs = lambda iv, n_use: obs if iv.start_epoch == 0 else None
    res = rx.process(_noise(4.0))
    spans = _span_ends(res)
    assert len(spans) == 2, spans          # one C/N0 reset, one re-acquire
    assert spans[1][2] == res.cn0_epochs.size, \
        ("re-acquired slot was killed by a stale-obs horizon inherited "
         "from the previous occupant", spans)


def test_wire1_pack_unpack_roundtrip():
    """Device unpack of the 1-bit wire (eight sign bits/byte, levels
    +/-delta) inverts the host pack exactly."""
    rx = rx_stream.StreamingReceiver(FS, system="gps", n_slots=2,
                                     segment_s=0.25)
    rng = np.random.default_rng(6)
    v = rng.integers(-128, 128, (2, 4096), dtype=np.int8)
    off, delta = 0.5, 20.0
    vals = np.arange(256).astype(np.int8).astype(np.float32) + off
    lut = np.clip(np.floor(vals / (2.0 * delta)), -1, 0).astype(np.int8)
    q = lut[v.view(np.uint8)]
    qr = q.reshape(2, 8, q.shape[1] // 8).view(np.uint8)
    acc = np.zeros((2, q.shape[1] // 8), np.uint8)
    for k in range(8):
        acc |= (qr[:, k] & 1) << k
    packed = acc.view(np.int8)

    import jax.numpy as jnp
    rx._ingest_conv = ("i1", np.float32(delta))
    out = rx._ingest(cplx.CArray(jnp.asarray(packed[0]),
                                 jnp.asarray(packed[1])))
    want = (2.0 * q.astype(np.float32) + 1.0) * delta
    np.testing.assert_array_equal(np.asarray(out.re), want[0])
    np.testing.assert_array_equal(np.asarray(out.im), want[1])
    # the 1-bit wire is the sign quantizer: exactly two levels
    assert set(np.unique(want)) <= {-delta, delta}
    # and the sign of every reconstructed sample matches the source's
    # (centered) sign
    src = v.astype(np.float32) + off
    np.testing.assert_array_equal(want > 0, src > 0)


def test_native_quantpack_matches_numpy():
    """The C++ fused quantize+pack (rdr_quantpack) produces byte-exact
    wire output vs the numpy reference pack for every wire width."""
    from gps_jamming_tpu.native import reader as native_reader

    if not native_reader.quantpack_available():
        pytest.skip("native capture_reader not built")
    rng = np.random.default_rng(7)
    w = rng.integers(-128, 128, (2, 1 << 12), dtype=np.int8)
    W = w.shape[1]
    vals = np.arange(256).astype(np.int8).astype(np.float32) + 0.5

    lut4 = np.clip(np.round(vals / 3.0), -8, 7).astype(np.int8)
    q = lut4[w.view(np.uint8)]
    h = W // 2
    want4 = ((q[:, :h] & 15) | (q[:, h:] << 4)).astype(np.int8)
    np.testing.assert_array_equal(
        native_reader.quantpack(w, lut4, 4), want4)

    lut2 = np.clip(np.floor(vals / 24.0), -2, 1).astype(np.int8)
    q = lut2[w.view(np.uint8)]
    qr = q.reshape(2, 4, W // 4)
    want2 = ((qr[:, 0] & 3) | ((qr[:, 1] & 3) << 2)
             | ((qr[:, 2] & 3) << 4) | (qr[:, 3] << 6)).astype(np.int8)
    np.testing.assert_array_equal(
        native_reader.quantpack(w, lut2, 2), want2)

    lut1 = np.clip(np.floor(vals / 40.0), -1, 0).astype(np.int8)
    qb = lut1[w.view(np.uint8)].reshape(2, 8, W // 8).view(np.uint8)
    acc = np.zeros((2, W // 8), np.uint8)
    for k in range(8):
        acc |= (qb[:, k] & 1) << k
    np.testing.assert_array_equal(
        native_reader.quantpack(w, lut1, 1), acc.view(np.int8))


def test_wire_auto_resolution(tmp_path):
    """wire_bits='auto' resolves by raw byte rate: lossless 8-bit for
    GPS/Galileo (4.1/8.2 MB/s), 2-bit packing for GLONASS (20 MB/s) —
    the link policy documented in process_file."""
    rng = np.random.default_rng(8)
    path = str(tmp_path / "noise.bin")
    rng.integers(0, 256, 1 << 16, dtype=np.uint8).tofile(path)

    rx = rx_stream.StreamingReceiver(FS, system="gps", n_slots=2,
                                     segment_s=0.25)
    rx.process_file(path, wire_bits="auto", max_segments=0)
    assert rx._ingest_conv[0] == "i8"

    rx_glo = rx_stream.StreamingReceiver(10e6, system="glonass",
                                         n_slots=2, segment_s=0.25)
    rx_glo.process_file(path, wire_bits="auto", max_segments=0)
    assert rx_glo._ingest_conv[0] == "i2"
