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


# reference module -> its counterpart in the port, where the name differs
MODULE_PAIRS = {"launch/hlo_analysis.py": "launch/op_analysis.py"}
# (reference module, top-level name) with no counterpart, and why
NO_COUNTERPART = {
    ("core/predictor.py", "noisy_matrix_batch_jax"):
        "the JAX forecaster route; the port's is noisy_matrix_batch_torch",
    ("core/predictor.py", "regional_noisy_matrix_jax"):
        "the JAX forecaster route; the port's is "
        "regional_noisy_matrix_torch",
    ("kernels/ops.py", "on_tpu"):
        "the port routes by KernelConfig.use_cuda and the tensor's device",
    ("kernels/window_dp.py", "LANE_BLOCK"):
        "the Pallas grid's TPU lane tile; K1's CUDA grid has its own",
    ("launch/mesh.py", "ICI_BW"):
        "the TPU interconnect's rate; the H100's collective rate is LINK_BW",
    ("models/common.py", "softplus"):
        "the port calls torch.nn.functional.softplus",
    **{("launch/hlo_analysis.py", n): "HLO text parsing: the port has no "
       "HLO, it counts an op stream" for n in ("parse_module",
                                               "extract_trip_counts",
                                               "Instr", "Computation",
                                               "type_shape")},
}
REF_SRC = Path(__file__).resolve().parents[1] / "src" / "repro"


def _top_level_names(path: Path) -> set:
    """Public names a module defines (def, class, assignment) and, for a
    package's ``__init__``, the names it imports."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {n.id for t in node.targets for n in ast.walk(t)
                    if isinstance(n, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif path.name == "__init__.py" and isinstance(node, ast.ImportFrom):
            out |= {a.asname or a.name for a in node.names}
    return {n for n in out if not n.startswith("_")}


@pytest.mark.parametrize("rel", sorted(
    str(p.relative_to(REF_SRC)) for p in REF_SRC.rglob("*.py")))
def test_every_reference_module_has_its_counterpart(rel):
    """Each top-level name of each reference module has a counterpart of
    the same name in the port's module of the same path (the HLO
    analysis's is ``launch/op_analysis``), but for the stated list."""
    port_rel = MODULE_PAIRS.get(rel, rel)
    name = "repro_torch." + port_rel[:-3].replace("/", ".") \
        .replace(".__init__", "")
    module = importlib.import_module(name)
    missing = []
    for n in sorted(_top_level_names(REF_SRC / rel)):
        if (rel, n) in NO_COUNTERPART:
            assert not hasattr(module, n), (rel, n)
            continue
        if hasattr(module, n):
            continue
        if rel.endswith("__init__.py") and importlib.util.find_spec(
                f"{name}.{n}") is not None:
            continue  # a submodule the reference's package imports
        missing.append(n)
    assert missing == [], (rel, missing)
