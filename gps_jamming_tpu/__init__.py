"""gps_jamming_tpu — GNSS interference detection & localization in JAX.

A JAX/XLA framework with the capabilities of the reference
GPS-JAMMING system (see SURVEY.md): uint8 I/Q ingest, streaming Welch/FFT
spectral estimation, multi-flag jamming detection, CAF/TDOA/RSSI jammer
localization, a GPS L1 C/A receiver chain (acquisition/tracking/nav/PVT), and
a deterministic simulation library — built as sharded batched kernels rather
than threads + subprocesses + HTTP.
"""

__version__ = "0.1.0"

from .config import (DEFAULT_CONFIG, FrameworkConfig, GnssSystem)
