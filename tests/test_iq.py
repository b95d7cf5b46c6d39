"""uint8 I/Q ingest fidelity — both reference conventions bit-for-bit.

Oracles: worker.py:220-228 (centered), triangulateRSSI.py:29-31 (normalized),
sdrrcv.c:104-106 (int8).
"""
import numpy as np
import jax.numpy as jnp

from gps_jamming_tpu.ops import iq


def _raw(rng, n=4096):
    return rng.integers(0, 256, size=2 * n, dtype=np.uint8)


def test_centered_matches_reference(rng):
    raw = _raw(rng)
    got = np.asarray(iq.uint8_to_complex(jnp.asarray(raw)))
    f = raw.astype(np.float32) - 127.5
    want = f[0::2] + 1j * f[1::2]
    np.testing.assert_array_equal(got, want.astype(np.complex64))


def test_normalized_matches_reference(rng):
    raw = _raw(rng)
    got = np.asarray(iq.uint8_to_complex_normalized(jnp.asarray(raw)))
    f = (raw.astype(np.float32) - 127.5) / 127.5
    want = (f[0::2] + 1j * f[1::2]).astype(np.complex64)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_int8_matches_reference(rng):
    raw = _raw(rng)
    got = np.asarray(iq.uint8_to_int8(jnp.asarray(raw)))
    want = (raw.astype(np.int16) - 128).astype(np.int8)
    np.testing.assert_array_equal(got, want)


def test_file_roundtrip(tmp_path, rng):
    raw = _raw(rng, 1000)
    p = tmp_path / "cap.bin"
    p.write_bytes(raw.tobytes())
    x = iq.read_iq_file(str(p), convention="centered")
    assert x.dtype == np.complex64 and x.size == 1000
    # write back: centered floats in [-127.5, 127.5] round-trip to within 1 LSB
    iq.write_iq_file(str(tmp_path / "back.bin"), x)
    raw2 = np.fromfile(tmp_path / "back.bin", dtype=np.uint8)
    assert np.max(np.abs(raw2.astype(int) - raw.astype(int))) <= 1


def test_frame_shapes(rng):
    x = jnp.arange(100, dtype=jnp.float32)
    f = iq.frame(x, frame_len=16, hop=8)
    assert f.shape == (11, 16)
    np.testing.assert_array_equal(np.asarray(f[1]), np.arange(8, 24))
    fn = iq.frame_nonoverlap(x, 16)
    assert fn.shape == (6, 16)


def test_pad_to_multiple():
    x = jnp.ones((3, 10))
    y = iq.pad_to_multiple(x, 8)
    assert y.shape == (3, 16)
    assert float(y[0, 12]) == 0.0


def test_int8_to_planar_mxu_path(rng):
    # 2n a multiple of 256 -> matmul deinterleave path
    raw = _raw(rng, n=1024)
    x8 = iq.uint8_np_to_int8(raw.copy())
    want = raw.astype(np.float32) - 127.5
    for conv, tf in [("centered", lambda v: v),
                     ("normalized", lambda v: v / 127.5),
                     ("int8", lambda v: np.floor(v))]:
        got = iq.int8_to_planar(jnp.asarray(x8), convention=conv)
        w = tf(want) if conv != "int8" else (want - 0.5)
        np.testing.assert_allclose(np.asarray(got.re), w[0::2], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(got.im), w[1::2], rtol=0,
                                   atol=1e-6)


def test_int8_to_planar_fallback_path(rng):
    # 2n NOT a multiple of 256 -> bitcast path; must agree with the matmul path
    raw = _raw(rng, n=100)
    x8 = iq.uint8_np_to_int8(raw.copy())
    got = iq.int8_to_planar(jnp.asarray(x8))
    want = raw.astype(np.float32) - 127.5
    np.testing.assert_array_equal(np.asarray(got.re), want[0::2])
    np.testing.assert_array_equal(np.asarray(got.im), want[1::2])


def test_int8_to_planar_batched(rng):
    raw = rng.integers(0, 256, size=(3, 2 * 512), dtype=np.uint8)
    x8 = iq.uint8_np_to_int8(raw.copy())
    got = iq.int8_to_planar(jnp.asarray(x8))
    want = raw.astype(np.float32) - 127.5
    np.testing.assert_array_equal(np.asarray(got.re), want[:, 0::2])
    np.testing.assert_array_equal(np.asarray(got.im), want[:, 1::2])
