"""``torch_serve_lm_ecc --trace-demo`` against the reference example's
``trace_demo``: the same printed lines, the same JSONL and Chrome trace
bytes, on the reference's weights and the same numpy KV interval masks in
both packages; without a directory the files go under a new temporary
directory."""

import os

from test_torch_examples import _one_torch_thread  # noqa: F401
from test_torch_examples import load_port_example, reference_example, reference_weights
from test_torch_serve import Masks


def test_trace_demo_prints_the_references_lines(capsys, monkeypatch, tmp_path):
    reference_weights(monkeypatch)
    masks = Masks(seed=5, scale=6.0).install(monkeypatch)
    reference_example("serve_lm_ecc")["trace_demo"](str(tmp_path / "ref"))
    ref = capsys.readouterr().out.replace(str(tmp_path / "ref"), "DIR")
    got = load_port_example("torch_serve_lm_ecc").main(
        ["--trace-demo", str(tmp_path / "port"), "--device", "cpu"])
    out = capsys.readouterr().out.replace(str(tmp_path / "port"), "DIR")
    assert out == ref
    assert masks.calls > 0 and got["events"] > 0 and got["summary"] in ref
    for name in ("trace.jsonl", "trace.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()


def test_trace_demo_writes_under_a_temporary_directory_by_default(monkeypatch, tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    got = load_port_example("torch_serve_lm_ecc").main(["--trace-demo", "--device", "cpu"])
    assert os.path.dirname(os.path.dirname(got["jsonl"])) == str(tmp_path)
    assert os.path.getsize(got["jsonl"]) > 0 and os.path.getsize(got["chrome"]) > 0
