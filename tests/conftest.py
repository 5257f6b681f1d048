"""Test config: run JAX on CPU with 8 virtual devices so multi-device
sharding tests work without accelerator hardware (SURVEY.md §4: the x265
analog of 'multi-node without a cluster').

Tests marked ``gpu`` need the card: they skip here and run on the GPU
through ``python chip_smoke.py`` (its phase 5 runs ``pytest -m gpu`` in
the process that already holds the card).
"""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# no persistent compile cache from test runs (children inherit the env):
# the checkout stays free of CPU executables
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"

import jax  # noqa: E402

jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402

# Fast dev tier (x265 analog: the short `make test` smoke vs the full
# regression sweep, test/README): everything matching a pattern below is
# long-running conformance/e2e and gets @slow, so
# `pytest -m "not slow"` is the quick loop and plain `pytest` the full one.
# Patterns were derived from --durations of a full run (>=5s each).
_SLOW_PATTERNS = (
    "test_finalizer_split.py", "test_loopfilter_device.py",
    "test_analysis_io.py", "test_main10.py", "test_opengop.py",
    "test_twopass.py", "test_badapt.py", "test_slices.py",
    "test_ladder.py", "test_zones.py", "test_multiref.py",
    "test_bframes.py", "test_cu64.py",
    "test_aq.py::test_dqp_conformance",
    "test_deblock.py::test_deblock_conformance_de265",
    "test_deblock.py::test_deblock_changes_output",
    "test_api_misc.py::test_qpfile_open_gop_bframes",
    "test_api_misc.py::test_max_merge_limits_candidates",
    "test_api_misc.py::test_reconfigure_qp_midstream",
    "test_api_misc.py::test_qpfile_forces_keyframe_and_qp",
    "test_api_misc.py::test_aud_emission",
    "test_ratecontrol.py::test_vbv_limits_frame_bits",
    "test_ratecontrol.py::test_abr_converges",
    "test_ratecontrol.py::test_crf_monotone_and_conformant",
    "test_e2e_intra.py::test_lossless_conformance_libde265",
    "test_slicetype.py::test_scenecut_inserts_idr",
    "test_rdoq.py::test_rdoq_native_matches_oracle_and_conforms",
    "test_rdoq.py::test_rdoq_rd_positive",
    "test_intra_pred_device.py::test_pred_matches_native",
    "test_inter.py::test_ippp_conformance_libde265",
)


def pytest_collection_modifyitems(config, items):
    for item in items:
        if any(pat in item.nodeid for pat in _SLOW_PATTERNS):
            item.add_marker(pytest.mark.slow)


@pytest.fixture(autouse=True)
def _needs_gpu(request):
    """Skip ``gpu``-marked tests unless JAX runs on a GPU. Decided per
    test at run time, so every xdist worker collects the same tests."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs a GPU: run through python chip_smoke.py")
