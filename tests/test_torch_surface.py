"""The port's package surface against the reference's: ``repro_torch.core``
re-exports the names ``repro.core`` does (its ``throughput`` function
aside, which there hides the module of that name) and, beyond them, the
pool simulator's sharded and seed-path entry points and the fleet
engine's, and the uniform-commitment control pool equals the
reference's."""
import ast
import importlib
from pathlib import Path

import numpy as np
import pytest

import repro.core as jcore
import repro_torch
import repro_torch.core as core
from repro.core import policy_pool as jpool
from repro_torch.core import policy_pool

# what repro_torch.core re-exports beyond repro.core's names
PORT_EXTRA = {"simulate_one", "simulate_pool_jobs_monolithic",
              "simulate_pool_jobs_sharded", "simulate_pool_monolithic",
              "simulate_pool_regions_sharded", "simulate_fleet",
              "simulate_fleet_sharded"}


def _imported_names(package) -> set:
    tree = ast.parse(Path(package.__file__).read_text())
    return {a.asname or a.name for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) for a in node.names}


def test_core_reexports_the_reference_names():
    want = _imported_names(jcore)
    assert len(want) > 60
    missing = sorted(n for n in want if not hasattr(core, n))
    assert missing == []
    # the one name whose object differs: the module, not the function
    assert isinstance(core.throughput, type(importlib))
    assert callable(core.throughput.throughput)
    assert not PORT_EXTRA & want
    assert _imported_names(core) == (want - {"throughput"}) | PORT_EXTRA


@pytest.mark.parametrize("qs", [None, (0.1, 0.5, 0.9), (0.0, 1.0)])
def test_uniform_rand_deadline_pool_equals_reference(qs):
    args = () if qs is None else (qs,)
    got = policy_pool.uniform_rand_deadline_pool(*args)
    want = jpool.uniform_rand_deadline_pool(*args)
    assert [tuple(vars(s).values()) for s in got] == \
        [tuple(vars(s).values()) for s in want]
    a, b = policy_pool.specs_to_arrays(got), jpool.specs_to_arrays(want)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_package_docstring_names_every_family_and_training():
    doc = repro_torch.__doc__.lower()
    for word in ("dense", "moe", "ssm", "hybrid", "vlm", "audio",
                 "fine-tuning", "checkpoint", "elastic"):
        assert word in doc, word
