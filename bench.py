"""Benchmark: I/Q Msamples/s/chip on the fused detection + acquisition chain.

Runs the flagship forward step (uint8 ingest -> Welch PSD -> chunk-power
detection -> 32-PRN x 71-Doppler CAF acquisition) on the default JAX backend
(the GPU on a machine that has one) and compares against the
reference-equivalent NumPy/SciPy implementation of the same work on CPU
(the baseline proxy: the reference publishes no benchmark numbers —
BASELINE.md — so the natural baseline is its NumPy/FFTW-style host math).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""
import json
import time

import numpy as np


def _build_chain(n_scan: int = 8, acq_method: str = "pcf"):
    """One jitted step processes `n_scan` 512k-sample blocks via lax.scan.

    Per-sample WORK is identical to the single-block chain: a full cold
    32-PRN x (+/-7 kHz) x 10-code-period acquisition runs for EVERY 512k
    block, i.e. every 256 ms of capture. Scanning several blocks per
    dispatch only amortizes the fixed per-call dispatch overhead.

    acq_method 'pcf' (default since r3) = the post-correlation-FFT
    factorized search (ops.caf.caf_accumulate_pcf): same +/-7 kHz coverage
    on a FINER effective grid (max 50 Hz interior bias vs the reference's
    100 Hz) with 5 ms coherent groups (MORE sensitive than the reference's
    10 x 1 ms non-coherent sum) at ~4x fewer inverse DFTs. 'std' = the
    reference-shaped 71-bin-per-block search (r1/r2 chain).
    """
    import jax
    import jax.numpy as jnp
    from gps_jamming_tpu.config import DEFAULT_CONFIG as CFG
    from gps_jamming_tpu.models.receiver import acquisition as acq
    from gps_jamming_tpu.ops import caf, iq, power, spectral

    fs = CFG.frontend.sample_rate_hz
    n_code = 2048
    n_intg = 10                       # reference ACQINTG
    n_block = 1 << 19                 # 512k samples (~256 ms) per block

    # planar path: int8 ingest, host-precomputed replica planes
    replica = acq.gps_replica_table_host(fs, n_code)
    freqs = caf.doppler_bins(7000.0, 200.0)

    def block_step(_, raw_i8):
        x = iq.int8_to_planar(raw_i8)
        psd = spectral.welch_psd_p(x, fs, 1024)
        pm = power.chunk_power_p(x, 32768)
        base = power.power_baseline(pm, 5.0)
        thr = power.power_threshold_linear(base, 6.0)
        flags = pm > thr
        blocks = x[: n_intg * n_code].reshape(n_intg, n_code)
        if acq_method == "pcf":
            surf = caf.caf_accumulate_pcf(blocks, replica, fs,
                                          max_doppler_hz=7000.0)
        else:
            surf = caf.caf_accumulate(blocks, replica, freqs, fs)
        peak = jnp.max(surf, axis=(-2, -1))
        return 0, (psd, pm, flags, peak)

    def forward(raw_i8):
        import jax.lax as lax
        _, outs = lax.scan(block_step, 0, raw_i8)
        return outs

    rng = np.random.default_rng(0)
    raw_u8 = rng.integers(0, 256, (n_scan, 2 * n_block), dtype=np.uint8)
    raw = jnp.asarray(iq.uint8_np_to_int8(raw_u8))
    return jax.jit(forward), raw, n_scan * n_block


def _time_chain(jfn, raw, n_block, n_lo=2, n_hi=34, reps=5):
    """Sustained per-step time via the two-point (slope) method.

    Run the step n_lo times then n_hi times, each ending with one host
    fetch of the final outputs (which drains the queue), and take the
    slope (t_hi - t_lo)/(n_hi - n_lo): the fixed fetch latency cancels.
    Median of `reps` estimates.
    """
    import jax

    def fetch(out):
        return jax.tree_util.tree_map(np.asarray, out)

    def timed(n):
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = jfn(raw)
        fetch(out)
        return time.perf_counter() - t0

    fetch(jfn(raw))                      # warm up + drain
    lo = [timed(n_lo) for _ in range(reps)]
    hi = [timed(n_hi) for _ in range(reps)]
    dt = (float(np.median(hi)) - float(np.median(lo))) / (n_hi - n_lo)
    dt = max(dt, 1e-9)
    return n_block / dt / 1e6          # Msamples/s


def _time_cpu_reference(n_block, iters=2):
    """Reference-equivalent host math: scipy Welch + numpy chunk power +
    np.fft acquisition over the same (PRN x Doppler) grid."""
    from scipy import signal as ss
    fs = 2.048e6
    n_code = 2048
    n_intg = 10
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, 2 * n_block, dtype=np.uint8)

    # code replicas (32, 2048)
    import sys
    sys.path.insert(0, ".")
    from gps_jamming_tpu.ops.codes import gps_ca_table
    tbl = gps_ca_table()
    idx = (np.floor(np.arange(n_code) * 1.023e6 / fs).astype(int)) % 1023
    sampled = tbl[:, idx]
    rep = np.conj(np.fft.fft(sampled, axis=-1))
    freqs = np.arange(71) * 200.0 - 7000.0

    best = np.inf
    for _ in range(iters):
        t0 = time.perf_counter()
        f = raw.astype(np.float32) - 127.5
        x = (f[0::2] + 1j * f[1::2]).astype(np.complex64)
        _, _ = ss.welch(x, fs, nperseg=1024, return_onesided=False)
        pm = np.mean(
            np.abs(x[: (x.size // 32768) * 32768].reshape(-1, 32768)) ** 2,
            axis=-1)
        base = np.percentile(pm, 5.0)
        _ = pm > base * 10 ** 0.6
        blocks = x[: n_intg * n_code].reshape(n_intg, n_code)
        t = np.arange(n_code) / fs
        osc = np.exp(-2j * np.pi * freqs[:, None] * t[None, :])
        acc = np.zeros((32, 71, n_code), np.float32)
        for b in blocks:
            mixed = b[None, :] * osc                      # (71, n)
            mf = np.fft.fft(mixed, axis=-1)
            y = np.fft.ifft(mf[None, :, :] * rep[:, None, :], axis=-1)
            acc += np.abs(y).astype(np.float32) ** 2
        _ = acc.max(axis=(-2, -1))
        best = min(best, time.perf_counter() - t0)
    return n_block / best / 1e6        # best-of-N: conservative baseline


def _receiver_rows():
    """Receiver-chain metrics: the product StreamingReceiver end to end
    plus the device track scan, for GPS and GLONASS at native rates,
    folded into the single bench JSON line. A failure propagates and
    fails the run."""
    from gps_jamming_tpu.runtime import benchmarks as B
    out = {}
    # 20 s capture = 4 whole segments: the e2e number then reflects
    # steady-state pipelining rather than the first window's serial upload
    for system in ("gps", "glonass"):
        r = B.receiver_chain(system, seconds=20.0, segment_s=4.0)
        out[f"receiver_track_msps_{system}"] = \
            float(r["track_msamples_per_s"])
        out[f"receiver_track_realtime_{system}"] = \
            float(r["track_realtime_x"])
        out[f"receiver_e2e_realtime_{system}"] = float(r["e2e_realtime_x"])
    return out


def main():
    from gps_jamming_tpu.runtime.compile_cache import enable_compile_cache
    enable_compile_cache()
    jfn, raw, n_block = _build_chain()
    dev_msps = _time_chain(jfn, raw, n_block)
    cpu_msps = _time_cpu_reference(n_block)
    row = {
        "metric": "iq_detect_acquire_throughput",
        "value": round(dev_msps, 2),
        "unit": "Msamples/s/chip",
        "vs_baseline": round(dev_msps / cpu_msps, 2),
    }
    row.update(_receiver_rows())
    print(json.dumps(row))


if __name__ == "__main__":
    main()
