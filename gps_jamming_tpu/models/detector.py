"""Jamming detectors: power pre-scan, standalone chunk detector, and the
4-flag event state machine.

Batched re-expression of the reference's Python detector stack:
- `precalculate_power_profile` (worker.py:198-275): full-capture chunk power
  map -> 5th-percentile baseline -> +6 dB ITU-R threshold -> high-power byte
  ranges. Here: one jitted batched reduction.
- `checkIfJamming.py:7-67`: standalone chunk-threshold detector with event
  extraction, plus the median*4.8 calibration (:94-95).
- `check_jamming_conditions` + confirm/clear hysteresis (worker.py:363-458):
  the F1 power / F2 C-N0 drop / F3 residual integrity / F4 altitude state
  machine, re-expressed as a `lax.scan` over telemetry frames so an entire
  run's decision trace is one fused device computation.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DetectorConfig
from ..ops import power as power_ops

MAX_EVENTS = 64
MAX_RANGES = 64


# ---------------------------------------------------------------------------
# Power pre-scan (F1 map)
# ---------------------------------------------------------------------------

class PowerProfile(NamedTuple):
    power_map: jax.Array          # (n_chunks,) mean |IQ|^2 per chunk
    baseline: jax.Array           # scalar, 5th percentile
    threshold: jax.Array          # scalar, linear
    mask: jax.Array               # (n_chunks,) bool above-threshold


def power_profile(iq: jax.Array, cfg: DetectorConfig) -> PowerProfile:
    """Chunked power map + baseline + threshold mask (worker.py:198-268)."""
    pm = power_ops.chunk_power(iq, cfg.power_chunk_samples)
    base = power_ops.power_baseline(pm, cfg.baseline_percentile)
    thr = power_ops.power_threshold_linear(base, cfg.power_rise_db)
    return PowerProfile(pm, base, thr, pm > thr)


def power_profile_file(path: str, cfg: DetectorConfig,
                       max_samples: int | None = None,
                       block_chunks: int = 256) -> PowerProfile:
    """Bounded-HBM power pre-scan of a capture FILE (worker.py:198-268).

    Streams `block_chunks` power chunks (default 256 x 32768 samples =
    16 MiB of bytes) at a time: the device only ever holds one block, so
    the pre-scan cost is independent of capture length — the streaming
    twin of `power_profile` for the process_file product path. Blocks
    split on chunk boundaries and the final partial chunk is kept, so the
    chunk-power map is bit-identical to the one-shot path on the same
    bytes (same int8 'centered' ingest, same mean reduction shapes).
    """
    import os

    from ..ops import iq as iq_ops
    chunk = cfg.power_chunk_samples
    block = block_chunks * chunk
    n_total = os.path.getsize(path) // 2
    if max_samples is not None:
        n_total = min(n_total, int(max_samples))

    jfn = jax.jit(lambda r: power_ops.chunk_power_p(
        iq_ops.int8_to_planar(r), chunk))
    pms = []
    with open(path, "rb") as f:
        done = 0
        while done < n_total:
            m = min(block, n_total - done)
            raw = np.frombuffer(f.read(2 * m), dtype=np.uint8)
            if raw.size == 0:
                break
            pms.append(np.asarray(jfn(
                jnp.asarray(iq_ops.uint8_np_to_int8(raw)))))
            done += raw.size // 2
    pm = jnp.asarray(np.concatenate(pms) if pms
                     else np.zeros(0, np.float32))
    base = power_ops.power_baseline(pm, cfg.baseline_percentile)
    thr = power_ops.power_threshold_linear(base, cfg.power_rise_db)
    return PowerProfile(pm, base, thr, pm > thr)


def power_profile_ranges(profile: PowerProfile, cfg: DetectorConfig) -> list[tuple[int, int]]:
    """High-power byte ranges [(start_byte, end_byte)), worker.py:250-264."""
    return power_ops.extract_ranges(np.asarray(profile.mask),
                                    cfg.power_chunk_samples * 2)


def ranges_to_padded(ranges: list[tuple[int, int]],
                     max_ranges: int = MAX_RANGES) -> tuple[np.ndarray, int]:
    """Pad byte ranges to a static-shape (max_ranges, 2) int64 array."""
    arr = np.full((max_ranges, 2), -1, dtype=np.int64)
    n = min(len(ranges), max_ranges)
    for i in range(n):
        arr[i] = ranges[i]
    return arr, n


# ---------------------------------------------------------------------------
# Standalone chunk detector (checkIfJamming)
# ---------------------------------------------------------------------------

def standalone_chunk_powers(iq: jax.Array, cfg: DetectorConfig) -> jax.Array:
    """Per-chunk mean |IQ|^2 with the standalone detector's chunk size
    (131072 bytes = 65536 samples, checkIfJamming.py:5)."""
    return power_ops.chunk_power(iq, cfg.standalone_chunk_bytes // 2) - 1e-10


def standalone_events(chunk_powers: np.ndarray, threshold: float,
                      chunk_samples: int) -> list[tuple[int, int]]:
    """(start_sample, end_sample) events, matching analyze_file_for_jamming
    (checkIfJamming.py:22-63): edges at chunk boundaries, trailing event
    closed at the end of the file."""
    mask = np.asarray(chunk_powers) > threshold
    return power_ops.extract_ranges(mask, chunk_samples)


def calibrate_threshold(chunk_powers: jax.Array, factor: float = 4.8) -> jax.Array:
    """Suggested threshold = median * 4.8 (checkIfJamming.py:94-95)."""
    return jnp.median(chunk_powers) * factor


# ---------------------------------------------------------------------------
# 4-flag detector state machine
# ---------------------------------------------------------------------------

class TelemetryFrames(NamedTuple):
    """Batched telemetry inputs, one row per 100 ms frame (sdrout.c cadence).

    All arrays shape (n_frames,).
    """
    time_s: jax.Array
    buffcnt: jax.Array            # byte offset into the capture (int64 —
    #   a 10 MS/s GLONASS capture passes 2 GB in under 2 minutes, and the
    #   reference's Python byte offsets are unbounded (worker.py:287)
    cn0_avg: jax.Array            # mean C/N0 across tracked sats (0 if none)
    residual_median: jax.Array
    residual_bad_count: jax.Array  # sats with residual > single-sat threshold
    hgt: jax.Array
    nsat: jax.Array


class DetectorState(NamedTuple):
    jamming: jax.Array                 # bool
    pot_start_t: jax.Array             # float; -1 = None
    pot_start_buffcnt: jax.Array
    pot_end_t: jax.Array               # float; -1 = None
    active_start_t: jax.Array
    active_start_buffcnt: jax.Array
    cn0_hist: jax.Array                # (hist_len,)
    hist_count: jax.Array
    hist_pos: jax.Array
    events: jax.Array                  # (MAX_EVENTS, 4) start_b, end_b, t0, t1
    n_events: jax.Array


class DetectorTrace(NamedTuple):
    is_jamming: jax.Array
    f1: jax.Array
    f2: jax.Array
    f3: jax.Array
    f4: jax.Array
    median_cn0: jax.Array


def init_state(cfg: DetectorConfig) -> DetectorState:
    """Zero state. Byte counters are int64 and event rows float64 (exact
    for offsets up to 2^53) so >2 GB captures keep exact byte ranges; the
    whole scan runs under a local x64 scope in run_detector."""
    z = jnp.asarray
    return DetectorState(
        jamming=z(False),
        pot_start_t=z(-1.0, jnp.float64),
        pot_start_buffcnt=z(0, jnp.int64),
        pot_end_t=z(-1.0, jnp.float64),
        active_start_t=z(0.0, jnp.float64),
        active_start_buffcnt=z(0, jnp.int64),
        cn0_hist=jnp.zeros(cfg.cn0_history_len, jnp.float32),
        hist_count=z(0, jnp.int32),
        hist_pos=z(0, jnp.int32),
        events=jnp.full((MAX_EVENTS, 4), -1.0, jnp.float64),
        n_events=z(0, jnp.int32),
    )


def _ring_median(hist: jax.Array, count: jax.Array) -> jax.Array:
    """np.median over the `count` valid entries of the ring buffer."""
    n = hist.shape[0]
    valid = jnp.arange(n) < count
    vals = jnp.sort(jnp.where(valid, hist, jnp.inf))
    c = jnp.maximum(count, 1)
    lo = vals[jnp.maximum((c - 1) // 2, 0)]
    hi = vals[jnp.maximum(c // 2, 0)]
    return 0.5 * (lo + hi)


def _f1_lookup(buffcnt: jax.Array, ranges: jax.Array, n_ranges: jax.Array):
    """F1 flag + start byte of the containing range (worker.py:366-370,
    :419-423). ranges: (MAX_RANGES, 2) int64, -1 padded."""
    valid = jnp.arange(ranges.shape[0]) < n_ranges
    inside = valid & (ranges[:, 0] <= buffcnt) & (buffcnt <= ranges[:, 1])
    f1 = jnp.any(inside)
    idx = jnp.argmax(inside)
    start = jnp.where(f1, ranges[idx, 0], buffcnt)
    return f1, start


def four_flag_step(state: DetectorState, frame, ranges: jax.Array,
                   n_ranges: jax.Array, cfg: DetectorConfig):
    """One telemetry frame through the reference's detector logic."""
    t, buffcnt, cn0, res_med, bad_cnt, hgt, nsat = frame

    f1, f1_start_byte = _f1_lookup(buffcnt, ranges, n_ranges)

    # C/N0 history update (worker.py:320-325): append only when not jamming
    # and cn0 > 0; median used once history > 10 else current value.
    do_append = (~state.jamming) & (cn0 > 0)
    hist = jnp.where(do_append,
                     state.cn0_hist.at[state.hist_pos].set(cn0),
                     state.cn0_hist)
    hist_count = jnp.where(do_append,
                           jnp.minimum(state.hist_count + 1, hist.shape[0]),
                           state.hist_count)
    hist_pos = jnp.where(do_append,
                         (state.hist_pos + 1) % hist.shape[0],
                         state.hist_pos)
    median_cn0 = jnp.where(hist_count > 10, _ring_median(hist, hist_count), cn0)

    f2 = (hist_count > cfg.cn0_min_history) & (cn0 < median_cn0 - cfg.cn0_drop_db)
    f3 = (res_med > cfg.residual_median_m) | (bad_cnt >= cfg.min_bad_sats)
    f4 = (nsat > 0) & (jnp.abs(hgt) > cfg.max_altitude_m)
    nav_issue = (f3 | f4) & (nsat > 0)
    is_jamming_now = f1 | f2 | nav_issue

    # --- not-jamming branch: confirmation logic (worker.py:391-402) ---
    pot_start_new = jnp.where(state.pot_start_t < 0, t, state.pot_start_t)
    pot_start_buff_new = jnp.where(state.pot_start_t < 0, buffcnt,
                                   state.pot_start_buffcnt)
    sustained = (t - pot_start_new) >= cfg.confirm_duration_s
    confirm_f1 = (~state.jamming) & is_jamming_now & f1
    confirm_slow = (~state.jamming) & is_jamming_now & (~f1) & sustained
    confirm = confirm_f1 | confirm_slow

    # start bookkeeping (confirm_jamming_start, worker.py:415-431)
    start_byte = jnp.where(
        confirm_f1, f1_start_byte,
        jnp.where(pot_start_buff_new > 0, pot_start_buff_new, buffcnt))
    start_time = jnp.where(confirm_slow, pot_start_new, t)

    # --- jamming branch: clear logic (worker.py:403-413) ---
    pot_end_new = jnp.where(state.pot_end_t < 0, t, state.pot_end_t)
    clean = (t - pot_end_new) >= cfg.clear_duration_s
    clear = state.jamming & (~is_jamming_now) & clean

    # event append on clear (confirm_jamming_end, worker.py:441-458)
    ev = jnp.stack([state.active_start_buffcnt.astype(jnp.float64),
                    buffcnt.astype(jnp.float64),
                    state.active_start_t, t])
    events = jnp.where(clear,
                       state.events.at[state.n_events % MAX_EVENTS].set(ev),
                       state.events)
    n_events = jnp.where(clear, state.n_events + 1, state.n_events)

    jamming_next = jnp.where(state.jamming, ~clear, confirm)

    # Faithful reference state retention (worker.py:391-431): pot_start_t is
    # set only in the not-jamming branch when the slow path first trips, reset
    # only when not-jamming sees a clean frame, and RETAINED through an active
    # event (so a relapse right after an event confirms instantly with the old
    # potential start — reference behavior). pot_start_buffcnt is never reset.
    slow_arm = (~state.jamming) & is_jamming_now & (~f1) & (state.pot_start_t < 0)
    new_state = DetectorState(
        jamming=jamming_next,
        pot_start_t=jnp.where(
            (~state.jamming) & (~is_jamming_now), -1.0,
            jnp.where(slow_arm, t, state.pot_start_t)),
        pot_start_buffcnt=jnp.where(slow_arm, buffcnt,
                                    state.pot_start_buffcnt),
        pot_end_t=jnp.where(state.jamming & (~is_jamming_now) & (~clear),
                            pot_end_new, -1.0),
        active_start_t=jnp.where(confirm, start_time, state.active_start_t),
        active_start_buffcnt=jnp.where(confirm, start_byte,
                                       state.active_start_buffcnt),
        cn0_hist=hist, hist_count=hist_count, hist_pos=hist_pos,
        events=events, n_events=n_events,
    )
    trace = DetectorTrace(jamming_next, f1, f2, f3 & (nsat > 0),
                          f4, median_cn0)
    return new_state, trace


def run_detector(frames: TelemetryFrames, ranges: np.ndarray, n_ranges: int,
                 cfg: DetectorConfig) -> tuple[DetectorState, DetectorTrace]:
    """Scan the full telemetry stream through the detector.

    Returns the final state (with the padded event table) and the per-frame
    flag trace. A still-open event at stream end is closed at the last frame
    (the worker's finally-block behavior, worker.py:523).

    Runs under a local x64 scope: byte offsets are int64 on device (exact
    event byte ranges for arbitrarily large captures). The scan is one row
    per 100 ms telemetry frame, so the wide dtypes are compute-free.
    """
    with jax.enable_x64(True):
        ranges_j = jnp.asarray(np.asarray(ranges, np.int64))
        n_ranges_j = jnp.asarray(n_ranges)

        def step(state, frame):
            return four_flag_step(state, frame, ranges_j, n_ranges_j, cfg)

        time_s = jnp.asarray(np.asarray(frames.time_s), jnp.float64)
        buffcnt = jnp.asarray(np.asarray(frames.buffcnt), jnp.int64)
        xs = (time_s, buffcnt,
              jnp.asarray(np.asarray(frames.cn0_avg), jnp.float32),
              jnp.asarray(np.asarray(frames.residual_median), jnp.float32),
              jnp.asarray(np.asarray(frames.residual_bad_count),
                          jnp.float32),
              jnp.asarray(np.asarray(frames.hgt), jnp.float32),
              jnp.asarray(np.asarray(frames.nsat), jnp.float32))
        final, trace = jax.lax.scan(step, init_state(cfg), xs)

        # close trailing open event (no-op on an empty stream — a capture
        # shorter than one 100 ms telemetry frame has nothing to close)
        if time_s.shape[0] > 0:
            last_t = time_s[-1]
            last_b = buffcnt[-1]
            ev = jnp.stack([final.active_start_buffcnt.astype(jnp.float64),
                            last_b.astype(jnp.float64),
                            final.active_start_t, last_t])
            events = jnp.where(
                final.jamming,
                final.events.at[final.n_events % MAX_EVENTS].set(ev),
                final.events)
            n_events = jnp.where(final.jamming, final.n_events + 1,
                                 final.n_events)
            final = final._replace(events=events, n_events=n_events)
        final = jax.tree.map(np.asarray, jax.device_get(final))
        trace = jax.tree.map(np.asarray, jax.device_get(trace))
    return final, trace


def events_to_list(state: DetectorState) -> list[dict]:
    """Densify the padded event table into worker.py:449-455-style records."""
    n = int(state.n_events)
    ev = np.asarray(state.events)
    out = []
    for i in range(min(n, MAX_EVENTS)):
        s_b, e_b, t0, t1 = ev[i]
        out.append({
            "start_sample": int(s_b), "end_sample": int(e_b),
            "start_time": float(t0), "end_time": float(t1),
            "duration": float(t1 - t0),
        })
    return out
