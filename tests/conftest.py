"""Test configuration: run everything on a virtual 8-device CPU mesh with
float64 enabled.

Golden regression values are generated in float64 on CPU (like the
reference's seeded fixtures).  The GPU is driven separately by
``chip_smoke.py``.  The platform override happens here, before any JAX
computation runs, so the suite stays on the CPU even where a GPU is
visible.
"""

import os
import sys

# 8 virtual CPU devices for the sharding tests
os.environ['XLA_FLAGS'] = os.environ.get('XLA_FLAGS', '') + ' --xla_force_host_platform_device_count=8'

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# hermetic line coverage (CI uses real coverage.py; see tools/cov_lite.py)
_COV_OUT = os.environ.get('TNMF_TPU_COVLITE')
if _COV_OUT:
    import atexit
    import json
    from tools import cov_lite
    _pkg = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'tnmf_tpu')
    cov_lite.start(_pkg)
    atexit.register(lambda: print(json.dumps(
        {'coverage_pct': cov_lite.report(_COV_OUT)['total_pct']})))

REFERENCE_PATH = '/root/reference'

# ---------------------------------------------------------------------------
# XLA:CPU compiler segfault mitigation.  Running the whole quick tier in one
# process segfaults inside backend_compile (jaxlib 0.9.0) after ~1000
# accumulated compilations — reproducibly around tests/test_phased.py, but
# every file subset (each half, and every pairwise neighborhood of the
# crash site) passes in isolation, so the trigger is accumulated compiler
# state, not any one graph.  Dropping the in-memory executable caches every
# N tests resets that state at the cost of some recompiles.
# ---------------------------------------------------------------------------

_CACHE_CLEAR_EVERY = 150
_test_count = [0]


def pytest_runtest_teardown(item, nextitem):
    _test_count[0] += 1
    if _test_count[0] % _CACHE_CLEAR_EVERY == 0:
        jax.clear_caches()


def reference_available() -> bool:
    return os.path.isdir(os.path.join(REFERENCE_PATH, 'tnmf'))


# ---------------------------------------------------------------------------
# test tiering: the quick gate is `pytest -m "not slow"`.
#
# The patterns below hold breadth-only repetitions — geometry fuzz sweeps,
# per-backend golden repeats, subprocess example/demo galleries, heavy
# sweep/multiscale configurations — each of which keeps at least one
# representative sibling in the quick tier, so the quick gate still covers
# every feature with one configuration.  Centralized here (instead of
# per-file decorators) so the tier list is one auditable block; derived
# from the measured `--durations` of the full run (round-4 tiering).
# ---------------------------------------------------------------------------

_SLOW_PATTERNS = (
    # random-geometry breadth (the systematic parity grids stay quick)
    'test_phased.py::test_phased_random_geometry_fuzz',
    # 2-OS-process multi-host run (~3 min); virtual-mesh sharding tests stay quick
    'test_distributed.py::',
    # subprocess galleries: keep the reference's flagship example and the
    # cheapest demo as quick smoke, the rest is breadth
    'test_examples.py::test_example_runs[',
    'test_demos.py::test_demo_headless[',
    # golden minibatch energies: jax_conv covers the rule, jax_fft repeats
    # it per backend; scan==loop keeps the default ASG_MU quick
    'test_minibatch.py::test_expected_energy[jax_fft',
    'test_minibatch.py::test_python_loop_matches_scan[GSG_MU',
    'test_minibatch.py::test_python_loop_matches_scan[ASAG_MU',
    'test_minibatch.py::test_python_loop_matches_scan[Cyclic_MU',
    # heavy sweep configurations (the API/parity basics stay quick)
    'test_sweep.py::test_sweep_energy_traces',
    'test_sweep.py::test_sweep_mesh_parity_and_layout',
    'test_sweep.py::test_sweep_beta_and_mask_smoke',
    'test_sweep.py::test_sweep_tol_zero_runs_to_n_iterations',
    'test_sweep.py::test_sweep_matches_individual_fits',
    'test_sweep.py::test_sweep_tol_matches_fit_loop_tol_per_model',
    'test_sweep.py::test_sweep_phased_strategy_matches_individual',
    'test_sweep.py::test_sweep_transform_group_matches_individual',
    'test_regularizers.py::test_sweep_per_model_vectors',
    # sharded checkpoint roundtrips (the single-device roundtrips stay)
    'test_checkpoint.py::test_sharded_checkpoint_roundtrip',
    'test_multiscale.py::test_multiscale_sharded_checkpoint_roundtrip',
    'test_multiscale.py::test_minibatch_algorithms_decrease_energy',
    'test_serving_export.py::test_multiscale_correlate_init_and_export',
    'test_sparsity_inhibition.py::test_sparsity_monotone',
    'test_dot_strategy.py::test_partial_fit_under_mesh_matches_single_device',
)

#: quick-tier exceptions inside slow-marked galleries (one representative
#: example + the cheapest demo stay in the quick gate)
_QUICK_EXCEPTIONS = (
    'test_example_runs[shift_invariant_decomposition.py]',
    'test_demo_headless[1-D Synthetic Signals]',
)


def pytest_collection_modifyitems(config, items):
    import pytest
    for item in items:
        nid = item.nodeid
        if any(q in nid for q in _QUICK_EXCEPTIONS):
            continue
        if any(p in nid for p in _SLOW_PATTERNS):
            item.add_marker(pytest.mark.slow)
