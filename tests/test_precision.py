"""Matmul precision at the float32 contractions that TF32 can reach.

On the H100 a float32 dot at default precision may run in TF32. The
on-GPU smoke check (chip_smoke.py) measured the three contraction sites at
default and at "highest" precision: the PCF fine DFT (GPS and Galileo),
the FDMA fine DFT (GLONASS) and the tracking tap correlator all stayed
inside their bounds at default, so none is pinned. These tests hold that
decision on the jaxpr: every dot_general at those sites follows
`jax_default_matmul_precision`, and a pin would have to be made on purpose.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gps_jamming_tpu.models.receiver import glonass as glo
from gps_jamming_tpu.models.receiver import tracking
from gps_jamming_tpu.ops import caf, cplx
from gps_jamming_tpu.ops import reference as R

FS = 2.048e6


def _dot_precisions(fn, *args):
    """The `precision` parameter of every dot_general in fn's jaxpr."""
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return out


def _pcf_site():
    x = np.zeros((10, 2048), np.float32)
    rep = cplx.CArray(np.ones((2, 2048), np.float32),
                      np.zeros((2, 2048), np.float32))
    return (lambda r, i: caf.caf_accumulate_pcf(cplx.CArray(r, i), rep, FS),
            (x, x))


def _fdma_site():
    x = np.zeros((10, 10000), np.float32)
    rep = glo.replica_table_host(10e6, 10000)
    offs = glo.channel_offsets_hz(channels=(-1, 0, 1))
    return (lambda r, i: caf.caf_accumulate_pcf_fdma(
        cplx.CArray(r, i), rep, offs, 10e6), (x, x))


def _tracking_site():
    taps = jnp.zeros((4, 3, 2048), jnp.float32)
    mixed = cplx.CArray(jnp.zeros((4, 2048)), jnp.zeros((4, 2048)))
    return (lambda t, re, im: tracking._corr_taps(t, cplx.CArray(re, im)),
            (taps, mixed.re, mixed.im))


@pytest.mark.parametrize("site,n_dots", [
    (_pcf_site, 4), (_fdma_site, 4), (_tracking_site, 2)])
def test_contractions_follow_default_precision(site, n_dots):
    fn, args = site()
    precs = _dot_precisions(fn, *args)
    assert len(precs) == n_dots
    assert all(p is None for p in precs), precs


def test_default_precision_context_reaches_the_contractions():
    """The smoke check's "highest" runs rely on the config context."""
    fn, args = _pcf_site()
    with jax.default_matmul_precision("highest"):
        text = jax.jit(fn).lower(*args).as_text()
    assert "HIGHEST" in text or "highest" in text


@pytest.mark.gpu
def test_pcf_default_precision_within_bound_on_gpu(gpu):
    """TF32 headroom of the GPS PCF search on the card (2e-3 of the peak)."""
    rng = np.random.default_rng(3)
    x = cplx.CArray(rng.standard_normal((10, 2048)).astype(np.float32),
                    rng.standard_normal((10, 2048)).astype(np.float32))
    rep = cplx.CArray(rng.standard_normal((32, 2048)).astype(np.float32),
                      rng.standard_normal((32, 2048)).astype(np.float32))
    with jax.default_device(gpu):
        got = np.asarray(caf.caf_accumulate_pcf(x, rep, FS))
    want = R.caf_accumulate_pcf_np(x, rep, FS)
    assert np.max(np.abs(got - want)) / np.max(want) <= 2e-3
