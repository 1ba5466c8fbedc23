"""The port's examples against the reference's: ``torch_quickstart`` in
full and ``torch_serve_lm_ecc --share-demo`` print the
reference example's lines, number for number, and return the numbers they
print; the mesh demo is refused without a card; the examples default to
the card. The
serving examples run the reference's weights (``lm.init_params`` is
replaced in both packages' runs by the reference's draw) and, where KV
pages undervolt, the same numpy interval masks
(``test_torch_serve.Masks``). ``test_torch_examples_trace.py`` holds
``--trace-demo``, ``test_torch_examples_serve.py`` ``serve_lm_ecc``'s
``main`` and ``test_torch_examples_mnist.py`` the Fig. 3 example."""

import importlib.util
import os
import re
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_smoke_config as jget_smoke
from repro.models import lm as jlm
from repro_torch.models import base as tbase
from repro_torch.models import lm as tlm

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain codecs and fields are many small int64 torch ops: under
    pytest-xdist, workers that each run a thread per core contend for the
    cores; one intra-op thread a worker avoids that."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_port_example(name):
    """An ``examples/torch_*.py`` file as a module."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_example(name):
    """The globals of the reference's ``examples/<name>.py`` (its
    ``__main__`` block not run)."""
    return runpy.run_path(os.path.join(EXAMPLES, f"{name}.py"), run_name=f"reference_{name}")


def reference_weights(monkeypatch):
    """Both packages' ``lm.init_params`` give the reference's draw of the
    config (the port's through numpy)."""
    cache = {}
    real = jlm.init_params

    def draw(cfg):
        if cfg.name not in cache:
            cache[cfg.name] = real(jget_smoke(cfg.name), jax.random.PRNGKey(0))
        return cache[cfg.name]

    monkeypatch.setattr(jlm, "init_params", lambda cfg, key: draw(cfg))
    monkeypatch.setattr(tlm, "init_params", lambda cfg, seed=0, device=None: (
        tbase.params_from_numpy(jax.tree_util.tree_map(np.asarray, draw(cfg)), cfg,
                                device=device)))


def test_quickstart_prints_the_references_lines(capsys):
    runpy.run_path(os.path.join(EXAMPLES, "quickstart.py"), run_name="__main__")
    ref = capsys.readouterr().out
    got = load_port_example("torch_quickstart").main(["--device", "cpu"])
    assert capsys.readouterr().out == ref
    rows = [r for r in ref.splitlines() if r.startswith("V=")]
    assert len(rows) == len(got["sweep"]) == 5
    for line, row in zip(rows, got["sweep"]):
        nums = dict(re.findall(r"(\w+)=\s*([\d.]+)", line))
        for k in ("faulty_words", "corrected", "detected", "silent", "wrong_values"):
            assert int(nums[k]) == row[k], (k, line)
    assert f"locked at {got['lock_v']:.2f} V" in ref
    assert got["sweep"][-1]["detected"] > 0 and got["sweep"][-1]["corrected"] > 0


def test_share_demo_prints_the_references_lines(capsys, monkeypatch):
    reference_weights(monkeypatch)
    reference_example("serve_lm_ecc")["share_demo"]()
    ref = capsys.readouterr().out
    got = load_port_example("torch_serve_lm_ecc").main(["--share-demo", "--device", "cpu"])
    assert capsys.readouterr().out == ref
    assert got["shared_identical"] and got["spec_identical"] and got["prefix_hit_tokens"] > 0
    assert f"{got['prefix_hit_tokens']} prompt tokens prefilled" in ref


TRAIN_ARGS = ["--steps", "30", "--fail-at", "27", "--batch", "8", "--seq", "32"]
TRAIN_LINE = re.compile(r"arch=(\S+) steps=(\d+) loss ([\d.]+) -> ([\d.]+) recoveries=(\d+) "
                        r"stragglers=(\d+)")


def test_train_lm_prints_the_references_lines(capsys, monkeypatch):
    """The reference's lines: the failure at step 27, restored from the
    ECC checkpoint of step 25, then the summary line (its losses within
    2e-3 of the reference's at 3 decimals; straggler lines and counts
    follow the host's clock and are not compared)."""
    reference_weights(monkeypatch)
    # the port first: the reference's trainer donates (deletes) the drawn arrays
    got = load_port_example("torch_train_lm").main(TRAIN_ARGS + ["--device", "cpu"])
    lines = [l for l in capsys.readouterr().out.splitlines() if not l.startswith("straggler")]
    monkeypatch.setattr(sys, "argv", ["train_lm.py"] + TRAIN_ARGS)
    reference_example("train_lm")["main"]()
    ref = [l for l in capsys.readouterr().out.splitlines() if not l.startswith("straggler")]
    assert lines[:-1] == ref[:-1] == ["*** simulated node failure at step 27 ***", ""]
    (g,), (r,) = TRAIN_LINE.findall(lines[-1]), TRAIN_LINE.findall(ref[-1])
    assert g[:2] == r[:2] == ("qwen3-0.6b", "32") and g[4] == r[4] == "1"
    np.testing.assert_allclose([float(g[2]), float(g[3])], [float(r[2]), float(r[3])], atol=2e-3)
    assert got["recoveries"] == 1 and len(got["losses"]) == 32
    assert got["losses"][-1] < got["losses"][0]
    assert f"loss {got['losses'][0]:.3f} -> {got['losses'][-1]:.3f}" in lines[-1]


def test_mesh_demo_is_refused_naming_multi_device(monkeypatch):
    """The mesh demo takes every visible card as a shard: with none and no
    ``--device`` it is refused, naming the cards, before any model is
    made (with ``--device cpu`` it serves on a one-shard mesh:
    ``test_torch_examples_serve.py``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="visible cards"):
        load_port_example("torch_serve_lm_ecc").main(["--mesh-demo"])


@pytest.mark.parametrize("name,argv", [("torch_quickstart", []),
                                       ("torch_mnist_undervolt", ["--steps", "1"]),
                                       ("torch_serve_lm_ecc", []),
                                       ("torch_serve_lm_ecc", ["--share-demo"]),
                                       ("torch_train_lm", ["--steps", "1"])])
def test_examples_default_to_the_card(monkeypatch, name, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_port_example(name).main(argv)


def test_port_examples_import_neither_jax_nor_the_reference():
    """Each port example loads with ``jax`` and ``repro`` made unimportable."""
    root = os.path.dirname(EXAMPLES)
    code = (
        "import importlib.util, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {os.path.join(root, 'src')!r})\n"
        "for name in ('torch_quickstart', 'torch_mnist_undervolt', 'torch_serve_lm_ecc',"
        " 'torch_train_lm'):\n"
        f"    spec = importlib.util.spec_from_file_location(name, {EXAMPLES!r} + f'/{{name}}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')"
        " and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=root)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
