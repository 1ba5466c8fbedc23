"""``torch_mnist_undervolt`` against the reference example at a reduced
``--steps``, the port's MLP started from the reference's initial weights:
the same printed lines (training loss, fault-free error, the rail sweep
with and without ECC, the V_crash line); ``main`` returns the numbers it
prints. Faulty words, power and savings are equal; the loss agrees to
1e-4 relative and the error rates to ERR_PTS: float32 SGD in two frameworks
sums in other orders (``test_torch_nn_accel.TRAIN_RTOL``), so a trained
weight on an int8 rounding boundary may quantise one step apart, and a few
of the 4,000 test images change class under the same faults."""

import re
import sys

import numpy as np

from repro.core.nn_accel import EccMLP as JMLP
from test_torch_examples import _one_torch_thread  # noqa: F401
from test_torch_examples import load_port_example, reference_example

STEPS = 30
ERR_PTS = 0.1  # percentage points: 4 of the 4,000 test images
NUM = r"[-+]?\d+(?:\.\d+)?"


def _numbers(line):
    return [float(x) for x in re.findall(NUM, line)]


def test_mnist_example_prints_the_references_lines(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["mnist_undervolt.py", "--steps", str(STEPS)])
    reference_example("mnist_undervolt")["main"]()
    ref = capsys.readouterr().out.splitlines()
    port = load_port_example("torch_mnist_undervolt")
    real = port.EccMLP

    def from_reference_weights(sizes, platform="vc707", device=None):
        mlp = real(sizes, platform=platform, device=device)
        mlp.load_params([(np.asarray(l.w), np.asarray(l.b))
                         for l in JMLP(sizes, platform=platform).layers])
        return mlp

    monkeypatch.setattr(port, "EccMLP", from_reference_weights)
    got = port.main(["--steps", str(STEPS), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [re.sub(NUM, "#", x) for x in out] == [re.sub(NUM, "#", x) for x in ref]
    rows = [(a, b) for a, b in zip(ref, out) if re.match(r"\s*\d\.\d\d \|", a)]
    assert len(rows) == len(got["rows"]) == 9
    for (a, b), row in zip(rows, got["rows"]):
        (v, e1, e0, fw, p, sav), nb = _numbers(a), _numbers(b)
        assert (nb[0], nb[3], nb[4], nb[5]) == (v, fw, p, sav) and row["faulty_words"] == fw
        assert abs(nb[1] - e1) <= ERR_PTS and abs(nb[2] - e0) <= ERR_PTS, (a, b)
        assert f"{100 * row['err_ecc']:7.2f}%" in b
    loss_ref, loss = _numbers(ref[1]), _numbers(out[1])
    assert abs(loss[0] - loss_ref[0]) <= 1e-4 * abs(loss_ref[0]) + 1e-4
    assert abs(loss[1] - loss_ref[1]) <= ERR_PTS
    crash_ref, crash = _numbers(ref[-1]), _numbers(out[-1])
    assert abs(crash[0] - crash_ref[0]) <= ERR_PTS and crash[3:] == crash_ref[3:]
    assert f"train loss {got['loss']:.4f}" in out[1]
    assert got["rows"][-1]["faulty_words"] > 0
