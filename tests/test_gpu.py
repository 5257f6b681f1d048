"""Tests that need an NVIDIA GPU: each compares what the card computes
with the same call on the CPU device of the same process. They skip
elsewhere; ``python chip_smoke.py`` runs them on the card (phase 5), as
does ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``. The
smoke's phase 3 covers the transforms, gathers, MC and intra analysis
at 1080p widths; what is here is what it does not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _on_cpu(fn, *args, **kw):
    with jax.default_device(jax.devices("cpu")[0]):
        return fn(*(jnp.asarray(np.asarray(a)) for a in args), **kw)


@pytest.mark.parametrize("n", [8, 32])
def test_tq_chain_gpu_equals_cpu(n):
    """The whole transform/quant/dequant/inverse chain: card == CPU."""
    from x265_tpu.models.residual import tq_chain
    rng = np.random.default_rng(n)
    M = 512
    resi = rng.integers(-255, 256, (M, n, n)).astype(np.int32)
    qp = rng.integers(10, 45, M).astype(np.int32)
    scan = np.zeros(M, np.int32)
    kw = dict(n=n, dst=False, is_intra=False, bd=8, sdh=False,
              do_rdoq=False, lossless=False)
    with jax.enable_x64():
        gpu = tq_chain(jnp.asarray(resi), jnp.asarray(qp), jnp.asarray(scan),
                       **kw)
        cpu = _on_cpu(tq_chain, resi, qp, scan, **kw)
    for a, b in zip(gpu, cpu):
        assert np.array_equal(np.asarray(a), np.asarray(b))
