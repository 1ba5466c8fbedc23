"""``torch_serve_lm_ecc``'s ``main`` against the reference example's: the
per-voltage table, the single-rail lock, the multi-rail locks and per-domain
counters and the paged serve walking its kv rail print the reference's
lines, number for number, on the reference's weights with the same numpy
KV interval masks in both packages, and ``main`` returns the numbers it
prints. Its last part, the per-domain codecs with their escalation ladder,
draws the weight arena's masks on the device (``mask_source="device"``):
the port's Philox field equals the reference's ``jax.random`` draw in
distribution only (ROADMAP.md, known differences), so there the lines
are held in form: the same domains, codes from the ladder, locks on the
platform's rail."""

import re

from repro_torch.core.voltage import PLATFORMS
from test_torch_examples import _one_torch_thread  # noqa: F401
from test_torch_examples import load_port_example, reference_example, reference_weights
from test_torch_serve import Masks

CODECS_HEADER = "per-domain ECC codecs + DED-triggered escalation:"


def _shape(line):
    """A line with its code names and numbers blanked and its spaces
    dropped (the numbers' widths pad it)."""
    line = re.sub(r"\b(parity65|secded72|ileave88|dected79)\b", "CODE", line)
    return "".join(re.sub(r"-?\d+(\.\d+)?", "#", line).split())


def test_serve_main_prints_the_references_lines(capsys, monkeypatch):
    reference_weights(monkeypatch)
    port_masks = Masks(seed=9, scale=6.0).install(monkeypatch)
    reference_example("serve_lm_ecc")["main"]()
    ref = capsys.readouterr().out
    got = load_port_example("torch_serve_lm_ecc").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert port_masks.calls > 0
    head, tail = ref.split(CODECS_HEADER)
    thead, ttail = out.split(CODECS_HEADER)
    assert thead == head
    assert [_shape(x) for x in ttail.splitlines()] == [_shape(x) for x in tail.splitlines()]
    # the returned numbers are the printed ones
    for line, row in zip(head.splitlines()[2:6], got["table"]):
        assert line.startswith(f"{row['v']:5.2f} |") and f"{row['corrected']:9d}" in line
    assert f"locked at {got['single_rail']['lock_v']:.2f} V after " \
           f"{got['single_rail']['rounds']} rounds" in head
    rails = ", ".join(f"{d}={v:.2f}V" for d, v in sorted(got["multi_rail"]["locks"].items()))
    assert f"multi-rail locks: {rails}" in head
    assert sorted(got["multi_rail"]["locks"]) == ["attention", "embedding", "mlp"]
    assert f"in {got['serve']['steps']} decode steps" in head
    assert got["serve"]["kv_stats"]["corrected"] > 0
    v = PLATFORMS["vc707"]
    for d, row in got["codecs"].items():
        assert row["codec"] in ("secded72", "ileave88", "dected79"), (d, row)
        assert v.v_crash <= row["lock_v"] <= v.v_nom
        assert f"{d:>10}: locked {row['lock_v']:.2f} V under {row['codec']:>9}" in ttail
    assert got["codecs"]["mlp"]["codec"] == "dected79"


def test_mesh_demo_prints_the_references_lines(capsys, monkeypatch):
    """``--mesh-demo`` on a one-shard mesh (the reference's one host device;
    the port's ``--device cpu``): the reference's lines in form, since the
    mesh draws device masks, and the numbers it returns are the printed
    ones."""
    reference_weights(monkeypatch)
    reference_example("serve_lm_ecc")["mesh_demo"]()
    ref = capsys.readouterr().out
    got = load_port_example("torch_serve_lm_ecc").main(["--mesh-demo", "--device", "cpu"])
    out = capsys.readouterr().out
    assert [_shape(x) for x in out.splitlines()] == [_shape(x) for x in ref.splitlines()]
    assert out.splitlines()[0] == ref.splitlines()[0]
    assert got["n_shards"] == 1 and got["requests"] == 3 and set(got["shard_of"].values()) == {0}
    v = PLATFORMS["vc707"]
    chip = got["chips"][0]
    assert sorted(chip["rails"]) == ["attention", "embedding", "kv", "mlp"]
    assert all(v.v_crash <= x <= v.v_nom for x in chip["rails"].values())
    rails = ", ".join(f"{d[:4]}={x:.2f}" for d, x in sorted(chip["rails"].items()))
    assert f"  chip 0: {rails} | kv scrubs corrected={chip['corrected']} " \
           f"detected={chip['detected']}" in out
    assert f"served 3 requests across 1 chips ({got['steps']} dispatch steps" in out
    assert f"{100 * got['saving']:.1f}% saving vs nominal" in out
