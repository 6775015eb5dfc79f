"""The PyTorch port stands alone: importing it loads neither JAX nor the JAX
package, its kernel module imports without a CUDA compiler, and its entry
points refuse to run quietly on the CPU when no card is present."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SRC = str(Path(__file__).resolve().parents[1] / "src")


def _run(code: str, env_extra=None):
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("JAX_PLATFORMS", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_loads_neither_jax_nor_reference():
    proc = _run(
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or"
        " k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "print(len(names), bad)\n"
        "assert not bad, bad\n"
    )
    assert proc.returncode == 0, proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 15, proc.stdout


def test_import_needs_neither_msgpack_nor_zstandard():
    """The card's machine has neither msgpack nor zstandard: walking every
    module (checkpoints included) succeeds with both blocked, and loads
    neither JAX nor the reference."""
    proc = _run(
        "import sys\n"
        "sys.modules['msgpack'] = None\n"
        "sys.modules['zstandard'] = None\n"
        "import importlib, pkgutil\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or"
        " k.startswith('jax.') or k == 'repro' or k.startswith('repro.')"
        " or (k in ('msgpack', 'zstandard') and sys.modules[k] is not None))\n"
        "assert 'repro_torch.checkpoint.ckpt' in names\n"
        "assert 'repro_torch.train.elastic' in names\n"
        "print(len(names), bad)\n"
        "assert not bad, bad\n"
    )
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", ["repro_torch.chaos", "repro_torch.obs",
                                    "repro_torch.data",
                                    "repro_torch.scenarios"])
def test_host_packages_load_neither_jax_nor_reference(module):
    """The numpy-only copies (fault injection, the flight recorder's
    ledgers, the regime generators) and the stress workloads stand alone
    too, each imported first in a fresh process."""
    proc = _run(
        "import sys\n"
        f"import {module}\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or"
        " k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
    )
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", [
    "repro_torch.core.policies", "repro_torch.core.simulator",
    "repro_torch.core.offline_opt", "repro_torch.core.region_market",
    "repro_torch.core.predictor", "repro_torch.core.policy_pool",
    "repro_torch.core.fast_sim", "repro_torch.core.engine",
    "repro_torch.core.fleet", "repro_torch.core.multi_job",
    "repro_torch.core.selector", "repro_torch.models.moe",
    "repro_torch.configs.mixtral_8x7b", "repro_torch.configs.mixtral_8x22b",
    "repro_torch.models.frontends", "repro_torch.models.rope",
    "repro_torch.configs.qwen2_vl_7b", "repro_torch.configs.hubert_xlarge",
    "repro_torch.launch.mesh", "repro_torch.sharding",
])
def test_reference_chain_modules_load_neither_jax_nor_reference(module):
    """The host reference chain (python policies, simulator, offline
    optimum, regional market and forecasters), the regional engine and
    the pool mesh with its sharding rules stand alone, each imported first
    in a fresh process."""
    proc = _run(
        "import sys\n"
        f"import {module}\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or"
        " k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
    )
    assert proc.returncode == 0, proc.stderr


def test_kernel_module_imports_without_nvcc(tmp_path):
    """Importing the kernel module builds nothing; without a compiler the
    build raises (no fallback), while CPU tensors still take the plain
    version."""
    proc = _run(
        "import torch\n"
        "from repro_torch.kernels import window_dp as k\n"
        "c = torch.zeros((2, 1, 3)); g = torch.zeros((2, 3))\n"
        "n, o = k.window_dp(c, g)\n"
        "assert n.shape == (2, 1) and k.window_dp.launches == 0\n"
        "try:\n"
        "    k.build()\n"
        "except RuntimeError as e:\n"
        "    assert 'nvcc' in str(e), e\n"
        "    print('raised')\n",
        {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path)},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "raised"


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.core import engine, fast_sim, selector, window_opt
    from repro_torch.core.policy_pool import paper_pool, specs_to_arrays
    from repro_torch.workload import PAPER_JOB, PAPER_TPUT, job_stream_arrays

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jobs = job_stream_arrays(np.random.default_rng(0), 2)
    prices = np.full((2, 10), 0.5, np.float32)
    avail = np.full((2, 10), 4, np.int64)
    preds = np.zeros((2, 10, fast_sim.W1MAX, 2), np.float32)
    pool = specs_to_arrays(paper_pool()[:3])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.simulate_and_select(pool, jobs, PAPER_TPUT, prices, avail,
                                   preds)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fast_sim.simulate_pool_jobs(pool, jobs, PAPER_TPUT, prices, avail,
                                    preds)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        window_opt.solve_window_batch(
            PAPER_JOB, PAPER_TPUT, np.zeros(2, np.float32),
            np.full(2, 3, np.int32), prices[:, :6], avail[:, :6], 1.0, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        selector.eg_init(4, 10)
    # an explicit device still runs
    res = engine.simulate_and_select(pool, jobs, PAPER_TPUT, prices, avail,
                                     preds, device="cpu")
    assert res.max_weight.shape == (2,)


def test_reference_chain_entry_points_raise_without_cuda(monkeypatch):
    """The python AHAP's window solve, the regional scans and engine, and
    the device forecast stacks run on the card unless told otherwise."""
    from repro_torch.core import engine, fast_sim, predictor, window_opt
    from repro_torch.core.market import vast_like_trace
    from repro_torch.core.policies import AHAP, AHAPParams, Obs
    from repro_torch.core.policy_pool import region_pool, specs_to_arrays
    from repro_torch.workload import PAPER_JOB, PAPER_TPUT, job_stream_arrays

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jobs = job_stream_arrays(np.random.default_rng(0), 2)
    prices = np.full((2, 3, 10), 0.5, np.float32)
    avail = np.full((2, 3, 10), 4, np.int64)
    preds = np.zeros((2, 3, 10, fast_sim.W1MAX, 2), np.float32)
    pool = specs_to_arrays(region_pool()[:4])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        window_opt.solve_window_numpy(PAPER_JOB, PAPER_TPUT, 0.0, 3,
                                      prices[0, 0, :4], avail[0, 0, :4], 1.0)
    ahap = AHAP(AHAPParams(3, 1, 0.7))
    ahap.reset(PAPER_JOB, PAPER_TPUT)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ahap.decide(Obs(t=0, price=0.5, avail=4, z_prev=0.0, n_prev=0,
                        pred=preds[0, 0, 0]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fast_sim.simulate_pool_regions(pool, jobs, PAPER_TPUT, prices, avail,
                                       preds, delta_mig=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.simulate_and_select(pool, jobs, PAPER_TPUT, prices, avail,
                                   preds, delta_mig=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predictor.noisy_matrix_batch_torch(prices[:, 0], avail[:, 0],
                                           "fixed_uniform", 0.1, [1, 2], 5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.prepare_noisy_inputs(vast_like_trace(seed=0, days=1), [0, 5],
                                    10, "fixed_uniform", 0.1, [1, 2],
                                    prep_backend="torch")
    res = engine.simulate_and_select(pool, jobs, PAPER_TPUT, prices, avail,
                                     preds, delta_mig=1, device="cpu")
    assert res.max_weight.shape == (2,)


def test_kernel_wrapper_rejects_non_cuda_tensors():
    """A tensor that is on neither the CPU nor a CUDA device is refused, not
    routed to the plain version."""
    from repro_torch.kernels.window_dp import window_dp

    c = torch.zeros((2, 1, 3), device="meta")
    g = torch.zeros((2, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        window_dp(c, g)
    assert window_dp.launches == 0


@pytest.mark.parametrize("name,call", [
    ("lora_matmul", "k.lora_matmul(torch.ones((2, 3)), torch.ones((3, 4)), "
                    "torch.ones((3, 1)), torch.ones((1, 4)), 2.0)"),
    ("flash_attention", "k.flash_attention(torch.ones((1, 2, 64)), "
                        "torch.ones((1, 2, 64)), torch.ones((1, 2, 64)))"),
])
def test_k2_k3_modules_import_without_nvcc(tmp_path, name, call):
    """K2's and K3's modules import and run their plain version on CPU
    tensors without a compiler; their build() raises naming nvcc."""
    proc = _run(
        "import torch\n"
        f"from repro_torch.kernels import {name} as k\n"
        f"y = {call}\n"
        f"assert torch.isfinite(y).all() and k.{name}.launches == 0\n"
        "try:\n"
        "    k.build()\n"
        "except RuntimeError as e:\n"
        "    assert 'nvcc' in str(e), e\n"
        "    print('raised')\n",
        {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path)},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "raised"


def test_k4_module_imports_without_nvcc(tmp_path):
    """K4's module imports and runs its plain version on CPU tensors without
    a compiler; its build() raises naming nvcc."""
    proc = _run(
        "import torch\n"
        "from repro_torch.kernels import ssd_scan as k\n"
        "y, h = k.ssd_scan(torch.ones((2, 5, 32)), torch.ones((2, 5)),\n"
        "                  -torch.ones(2), torch.ones((2, 5, 16)),\n"
        "                  torch.ones((2, 5, 16)))\n"
        "assert y.shape == (2, 5, 32) and h.shape == (2, 16, 32)\n"
        "assert torch.isfinite(y).all() and k.ssd_scan.launches == 0\n"
        "try:\n"
        "    k.build()\n"
        "except RuntimeError as e:\n"
        "    assert 'nvcc' in str(e), e\n"
        "    print('raised')\n",
        {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path)},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "raised"


def test_kernel_libraries_named_by_source_hash():
    """One build helper serves K1-K4: each library sits in build/repro_torch/
    under its source's stem and the hash of its bytes and of the shared
    headers (K2 and K3 include csrc/tensor_core.cuh)."""
    import hashlib

    from repro_torch.kernels import build, flash_attention, lora_matmul
    from repro_torch.kernels import ssd_scan, window_dp

    headers = sorted(build.CSRC.glob("*.cuh"))
    assert build.CSRC / "tensor_core.cuh" in headers
    paths = set()
    for mod in (window_dp, lora_matmul, flash_attention, ssd_scan):
        path = build.library_path(mod.SOURCE)
        digest = hashlib.sha256((build.CSRC / mod.SOURCE).read_bytes())
        for header in headers:
            digest.update(header.read_bytes())
        assert path.parent == build.BUILD_DIR
        assert path.parent.parts[-2:] == ("build", "repro_torch")
        assert path.name == (f"{mod.SOURCE[:-3]}_"
                             f"{digest.hexdigest()[:16]}.so")
        paths.add(path)
    assert len(paths) == 4


def test_k2_k3_wrappers_reject_non_cuda_tensors():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lora_matmul import lora_matmul

    m = torch.zeros((4, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        lora_matmul(m, torch.zeros((64, 8), device="meta"),
                    torch.zeros((64, 2), device="meta"),
                    torch.zeros((2, 8), device="meta"), 1.0)
    q = torch.zeros((1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
    assert lora_matmul.launches == 0 and flash_attention.launches == 0


def test_k4_wrapper_rejects_non_cuda_tensors():
    from repro_torch.kernels.ssd_scan import ssd_scan

    x = torch.zeros((2, 8, 32), device="meta")
    b = torch.zeros((2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(x, torch.zeros((2, 8), device="meta"),
                 torch.zeros((2,), device="meta"), b, b)
    assert ssd_scan.launches == 0


def test_fleet_and_moe_entry_points_raise_without_cuda(monkeypatch):
    """The fleet engine, the oracle's python AHAP and the MoE model run on
    the card unless told otherwise."""
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import fast_sim, fleet
    from repro_torch.core.policy_pool import KIND_MSU
    from repro_torch.serve import ServingEngine
    from repro_torch.workload import PAPER_JOB, PAPER_TPUT

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ({"kind": np.array([KIND_MSU])}, fast_sim.stack_jobs([PAPER_JOB]),
            [0], PAPER_TPUT, np.full(4, 0.5, np.float32), np.full(4, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fleet.simulate_fleet(*args)
    assert fleet.simulate_fleet(*args, device="cpu")["n_spot"].shape == (1, 4)
    cfg = get_smoke_config("mixtral-8x7b")
    vals = convert.random_model_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.model_params(vals, cfg)
    params = convert.model_params(vals, cfg, "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, params)
