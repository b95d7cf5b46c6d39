"""Typed configuration tree for the whole framework.

Replaces the reference's scattered configuration: the hardcoded per-system
front-end parameters of `sdrinit.c:3-125`, the detector thresholds of
`app/worker.py:78-95`, the RSSI/TDOA constants of `skrypty/triangulateRSSI.py:8-20`
and `skrypty/triangulateTDOA.py:13-29`, and the simulation constants of
`simulate/frontend/add_jammer_and_mix.py:8-12`.

Everything is a frozen dataclass so configs are hashable and can be passed as
static arguments to jitted functions.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

from .utils import constants as C


class GnssSystem(enum.Enum):
    GPS = "GPS"
    GLONASS = "GLONASS"
    GALILEO = "Galileo"


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """RF front-end / capture parameters (reference: `sdrinit.c:3-125`)."""
    sample_rate_hz: float = C.DEFAULT_SAMPLE_RATE_GPS
    center_freq_hz: float = C.GPS_L1_FREQ_HZ
    intermediate_freq_hz: float = 0.0
    system: GnssSystem = GnssSystem.GPS

    @property
    def ts(self) -> float:
        return 1.0 / self.sample_rate_hz

    @classmethod
    def for_system(cls, system: GnssSystem) -> "FrontendConfig":
        if system == GnssSystem.GLONASS:
            return cls(sample_rate_hz=C.DEFAULT_SAMPLE_RATE_GLO,
                       center_freq_hz=C.GLO_G1_BASE_FREQ_HZ, system=system)
        if system == GnssSystem.GALILEO:
            return cls(center_freq_hz=C.GAL_E1_FREQ_HZ, system=system)
        return cls(system=system)


@dataclasses.dataclass(frozen=True)
class AcquisitionConfig:
    """Acquisition search grid (reference: `sdr.h:59-66`, `sdracq.c:52-81`)."""
    doppler_max_hz: float = 7000.0       # +/- search span
    doppler_step_hz: float = 200.0       # -> 71 bins
    n_integration: int = 10              # non-coherent code periods (ACQINTG)
    peak_ratio_threshold: float = 3.0    # ACQTH
    exclude_chips: float = 2.0           # second-peak exclusion half-width
    # 'std' = reference-shaped per-Doppler non-coherent search;
    # 'pcf' = post-correlation-FFT factorized search (~4x fewer inverse
    # DFTs, finer effective grid); 'auto' (default) picks pcf when its
    # inverse-row count wins (caf.pcf_profitable). GLONASS picks its FDMA
    # search form in glonass.acquire_all and ignores this knob
    method: str = "auto"

    @property
    def n_doppler(self) -> int:
        return int(round(2 * self.doppler_max_hz / self.doppler_step_hz)) + 1


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """PLL/DLL loop parameters (reference: `sdrinit.c:27-32`, `:187-207`).

    The reference derives 2nd-order loop-filter coefficients from noise
    bandwidths via the standard 0.53 rule: wn = B / 0.53, with damping 0.707.
    prm1 = pull-in stage, prm2 = locked stage.
    """
    dll_bw_pullin_hz: float = 5.0
    pll_bw_pullin_hz: float = 30.0
    fll_bw_pullin_hz: float = 200.0
    dll_bw_locked_hz: float = 2.0
    pll_bw_locked_hz: float = 20.0
    fll_bw_locked_hz: float = 50.0
    damping: float = 0.707
    n_taps: int = 4                      # correlator taps each side of prompt
    tap_spacing_samples: int = 1         # corrp: spacing between taps
    pullin_ms: int = 800                 # loop-switch time (sdrinit LOOP_MS)
    snr_smooth_ms: int = 100             # SNSMOOTHMS


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Jamming detector thresholds (reference: `worker.py:78-95`, `:152-153`)."""
    power_chunk_samples: int = 32768            # POWER_CHUNK_SIZE
    power_rise_db: float = 6.0                  # F1: ITU-R rise over baseline
    baseline_percentile: float = 5.0            # 5th-percentile noise baseline
    cn0_drop_db: float = 8.0                    # F2
    cn0_history_len: int = 100
    cn0_min_history: int = 40                   # arm F2 only after this many
    residual_median_m: float = 40.0             # F3
    residual_single_sat_m: float = 800.0        # F3
    min_bad_sats: int = 2                       # F3
    max_altitude_m: float = 10_000.0            # F4
    confirm_duration_s: float = 2.5             # sustain before confirming
    clear_duration_s: float = 2.0               # clean time before clearing
    calibration_factor: float = 4.8             # checkIfJamming.py: median*4.8
    standalone_chunk_bytes: int = 131072        # checkIfJamming CHUNK_SIZE


@dataclasses.dataclass(frozen=True)
class RssiConfig:
    """RSSI localization (reference: `triangulateRSSI.py:8-20`)."""
    tx_power_dbm: float = 40.0
    path_loss_exponent: float = 3.0
    frequency_mhz: float = 1575.42
    signal_threshold: float = 0.1               # amplitude turn-on threshold
    grid_density: int = 300
    search_range_multiplier: float = 1.5


@dataclasses.dataclass(frozen=True)
class TdoaConfig:
    """TDOA localization (reference: `triangulateTDOA.py:13-29`)."""
    noise_sample_size: int = 200_000
    detection_window_size: int = 1000
    detection_threshold_factor: float = 50.0
    correlation_slice_size: int = 50_000
    # Improvement over the reference (BASELINE.md target): parabolic
    # sub-sample interpolation of the correlation peak.
    subsample_interp: bool = True


@dataclasses.dataclass(frozen=True)
class SpectralConfig:
    """Welch PSD / spectrogram (reference: `widmo_plot.py:8-10`, `:48`)."""
    nperseg: int = 1024
    overlap_frac: float = 0.5
    chunk_seconds: float = 1.0
    window: str = "hann"


@dataclasses.dataclass(frozen=True)
class PvtConfig:
    """PVT gates and solver (reference: `sdr.h:113-121`, `sdrpvt.c`)."""
    snr_min_dbhz: float = 19.0
    elevation_min_deg: float = 15.0
    elevation_weight_deg: float = 30.0      # inflate sigma below this
    week_min: int = 2360
    pr_window_s: Tuple[float, float] = (0.0, 0.092)   # LOW_PR..HIGH_PR
    max_iterations: int = 10
    base_variance: float = 25.0             # sigma^2 = 5^2
    det_tol: float = 1e-12
    converge_norm: float = 1e-10
    cadence_s: float = 0.2                  # outms = 200 ms
    hold_position_jump_deg: float = 1.0     # sdrout hold filter threshold


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Signal simulation (reference: `add_jammer_and_mix.py:8-12`, jammers/)."""
    gps_weaken_scale: float = 0.125
    jammer_power: float = 0.605
    noise_std: float = 6.25
    chirp_sweep_period_s: float = 2.0
    pulse_prf_hz: float = 1000.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout for pjit/shard_map pipelines."""
    antenna_axis: str = "antenna"
    time_axis: str = "time"
    n_antenna: int = 1
    n_time: int = 1


@dataclasses.dataclass(frozen=True)
class FrameworkConfig:
    """Top-level config tree."""
    frontend: FrontendConfig = FrontendConfig()
    acquisition: AcquisitionConfig = AcquisitionConfig()
    tracking: TrackingConfig = TrackingConfig()
    detector: DetectorConfig = DetectorConfig()
    rssi: RssiConfig = RssiConfig()
    tdoa: TdoaConfig = TdoaConfig()
    spectral: SpectralConfig = SpectralConfig()
    pvt: PvtConfig = PvtConfig()
    sim: SimConfig = SimConfig()
    mesh: MeshConfig = MeshConfig()

    @classmethod
    def for_system(cls, system: GnssSystem) -> "FrameworkConfig":
        return cls(frontend=FrontendConfig.for_system(system))


DEFAULT_CONFIG = FrameworkConfig()
