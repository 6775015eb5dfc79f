"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program. Each check runs in a fresh
interpreter: this test process may hold JAX from other tests."""
import json
import os
import subprocess
import sys
from pathlib import Path

from port_bench import run, testing

ROOT = Path(__file__).resolve().parents[1]

REFERENCE = """
import json, sys
from port_bench import train_check, catalog
for arch in ("moe", "ssm"):
    catalog.reference(arch)
print(json.dumps({"top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def _fresh(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_run_path_loads_neither_jax_nor_the_jax_package():
    _, got = testing.run_fresh("tiny.ssm", 7)
    assert got["rc"] == 0
    assert "repro_torch" in got["top"]
    assert not set(got["top"]) & {*run.FORBIDDEN, "benchmarks", "chip_smoke"}
    shunned = (ROOT / "benchmarks", ROOT / "BENCH_pool_sim.json",
               ROOT / "chip_smoke.py")
    for path in got["opened"]:
        p = Path(path).resolve()
        assert not any(p == s or s in p.parents for s in shunned), path


def test_the_reference_loads_nothing_of_the_program():
    top = set(_fresh(REFERENCE)["top"])
    assert not top & {*run.FORBIDDEN, "repro_torch"}


def test_names_are_compared_whole():
    assert run.forbidden_modules({"repro_torch.train": 0,
                                  "jaxtyping": 0}) == []
    assert run.forbidden_modules({"repro.core": 0, "jax.numpy": 0}) == [
        "jax", "repro"]
