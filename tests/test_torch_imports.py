"""Guards of the port: it imports neither JAX nor the reference package, and
the chip smoke script refuses to run without a card or without the port."""

import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _port_modules() -> list:
    import repro_torch

    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_port_modules_are_listed():
    mods = _port_modules()
    for m in ("repro_torch.kernels.ops", "repro_torch.serving.engine",
              "repro_torch.core.planestore", "repro_torch.models.lm",
              "repro_torch.kernels.paged_gather", "repro_torch.core.kvpages",
              "repro_torch.serving.steps", "repro_torch.serving.scheduler",
              "repro_torch.kernels.fault_inject", "repro_torch.core.memory",
              "repro_torch.core.nn_accel", "repro_torch.data.mnist",
              "repro_torch.configs.paper_nn", "repro_torch.codes.parity",
              "repro_torch.codes.interleaved", "repro_torch.codes.dected",
              "repro_torch.obs.events", "repro_torch.obs.metrics",
              "repro_torch.obs.recorder", "repro_torch.obs.export",
              "repro_torch.obs.report", "repro_torch.obs.profile",
              "repro_torch.core.scenario", "repro_torch.data.pipeline",
              "repro_torch.optim.adamw", "repro_torch.train.train_step",
              "repro_torch.train.trainer", "repro_torch.checkpoint.manager",
              "repro_torch.launch.mesh", "repro_torch.distributed.sharding",
              "repro_torch.distributed.collectives", "repro_torch.distributed.meshrel"):
        assert m in mods


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path[:0] = [{SRC!r}, {ROOT!r}]\n"
        "import importlib\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "import port_ab\n"
        "bad = sorted(m for m in sys.modules if (m in ('jax', 'repro') or m.startswith(('jax.', 'repro.')))"
        " and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the script would run")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
