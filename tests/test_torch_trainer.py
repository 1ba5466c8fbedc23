"""Port parity for the fault-tolerant trainer: the reference's trainer
tests on the port, a 12-step trajectory and the multi-rail RailPolicy's
rail events against the reference's on the same weights, and a mesh
trainer on a one-rank process group against the unsharded trainer."""

import tempfile

import numpy as np
import pytest
import torch

import jax

from conftest import tiny_cfg
from repro.data import pipeline as jpipe
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import train_step as jstep
from repro.train import trainer as jtrainer
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import base as tbase
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import TrainConfig
from repro_torch.train.trainer import (FaultInjected, RailPolicy, StragglerMonitor, Trainer)

CFG = tiny_cfg(vocab=64)
TCFG = tbase.ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
                         n_kv_heads=2, d_ff=128, vocab=64, head_dim=16)
DC_KW = dict(vocab=64, global_batch=8, seq_len=32)
OPT_KW = dict(lr=1e-3, warmup_steps=5, total_steps=100)
DC = DataConfig(**DC_KW)
TC = TrainConfig(optimizer=AdamWConfig(**OPT_KW), remat=None)
TRAJ_RTOL = 1e-3  # 12 steps: the two packages round the sums in other orders
RAIL_RUNS = ((2, 4), (1, 8))  # (scrub_every, steps)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain codecs and fields are many small int64 torch ops: one
    intra-op thread a pytest-xdist worker keeps the workers off each
    other's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_trainer(d, **kw):
    return jtrainer.Trainer(
        CFG, jstep.TrainConfig(optimizer=jadamw.AdamWConfig(**OPT_KW), remat=None),
        jpipe.TokenPipeline(jpipe.DataConfig(**DC_KW)), d, **kw)


def _port_trainer(d, **kw):
    """A CPU trainer started from the reference's weights."""
    tr = Trainer(TCFG, TC, TokenPipeline(DC), d, device="cpu", **kw)
    tr.params = tbase.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jlm.init_params(CFG, jax.random.PRNGKey(0))), TCFG,
        device="cpu")
    tr.opt_state = tadamw.init(tr.params, TC.optimizer)
    return tr


def _losses(hist):
    return [r["loss"] for r in hist if "loss" in r]


@pytest.fixture(scope="module")
def ref_runs():
    """The reference trainer's 12-step run and its RailPolicy runs from
    0.60 V (start_v below V_min starts at V_min): 4 steps scrubbing every
    2, and 8 steps scrubbing every step down the walk."""
    out = {}
    with tempfile.TemporaryDirectory() as d:
        out["traj"] = _losses(_ref_trainer(d, ckpt_every=100).run(12))
    for every, steps in RAIL_RUNS:
        with tempfile.TemporaryDirectory() as d:
            tr = _ref_trainer(d, ckpt_every=100,
                              rails=jtrainer.RailPolicy(scrub_every=every, start_v=0.60))
            out[every] = tr.run(steps)
    return out


# -- the reference's trainer tests on the port --------------------------------
def test_loss_decreases_and_resume_is_deterministic(tmp_path):
    d = str(tmp_path)
    tr = Trainer(TCFG, TC, TokenPipeline(DC), d, ckpt_every=5, device="cpu")
    h = tr.run(12)
    losses = _losses(h)
    assert losses[-1] < losses[0]
    tr2 = Trainer(TCFG, TC, TokenPipeline(DC), d, ckpt_every=5, device="cpu")
    assert tr2.restore() and tr2.step == 10
    l2 = _losses(tr2.run(2))
    np.testing.assert_allclose(losses[-2:], l2, rtol=1e-5)
    assert losses[-2:] == l2  # and bit for bit on the CPU


def test_fault_recovery_restores_and_continues(tmp_path):
    armed = {"on": True}

    def chaos(step):
        if step == 7 and armed["on"]:
            armed["on"] = False
            raise FaultInjected("boom")

    tr = Trainer(TCFG, TC, TokenPipeline(DC), str(tmp_path), ckpt_every=5, fault_hook=chaos,
                 device="cpu")
    tr.run(10)
    assert tr.recoveries == 1
    assert tr.step == 10
    events = [r for r in tr.history if r.get("event") == "recovery"]
    assert len(events) == 1 and events[0]["step"] == 5  # restored to ckpt 5
    assert events[0]["cause"] == "FaultInjected('boom')"


def test_recovery_without_a_checkpoint_reinitialises(tmp_path):
    armed = {"on": True}

    def chaos(step):
        if step == 2 and armed["on"]:
            armed["on"] = False
            raise FloatingPointError("nan")

    tr = Trainer(TCFG, TC, TokenPipeline(DC), str(tmp_path), ckpt_every=100, fault_hook=chaos,
                 device="cpu")
    h = tr.run(4)
    assert tr.recoveries == 1 and [r["step"] for r in h if r.get("event")] == [0]
    fresh = Trainer(TCFG, TC, TokenPipeline(DC), str(tmp_path / "x"), ckpt_every=100,
                    device="cpu")
    assert _losses(h)[2:] == _losses(fresh.run(4))  # steps 0-3 again after the re-init


def test_straggler_monitor():
    mon = StragglerMonitor(factor=3.0, warmup=3)
    for i in range(6):
        mon.observe(i, 0.1)
    assert not mon.events
    assert mon.observe(6, 1.0)  # 10x median
    assert mon.events[0].step == 6


# -- against the reference -----------------------------------------------------
def test_trajectory_agrees_with_the_reference(ref_runs, tmp_path):
    got = _losses(_port_trainer(str(tmp_path), ckpt_every=100).run(12))
    np.testing.assert_allclose(got, ref_runs["traj"], rtol=TRAJ_RTOL)


@pytest.mark.parametrize("every,steps", RAIL_RUNS)
def test_rail_policy_is_read_only_and_its_events_are_the_references(ref_runs, tmp_path, every,
                                                                    steps):
    plain = _port_trainer(str(tmp_path / "plain"), ckpt_every=100)
    h0 = plain.run(steps)
    railed = _port_trainer(str(tmp_path / "railed"), ckpt_every=100,
                           rails=RailPolicy(scrub_every=every, start_v=0.60))
    h1 = railed.run(steps)
    # scrubbing is a read path: training is bitwise unaffected
    assert _losses(h0) == _losses(h1)
    for (_, a), (_, b) in zip(tbase.flatten(plain.params), tbase.flatten(railed.params)):
        assert torch.equal(a, b)
    events = [r for r in h1 if r.get("event") == "rails"]
    ref = [r for r in ref_runs[every] if r.get("event") == "rails"]
    assert len(events) == len(ref) == steps // every
    assert set(events[0]["voltages"]) >= {"attention", "mlp", "embedding"}
    for e, r in zip(events, ref):
        assert set(e) == set(r)
        assert e["step"] == r["step"]
        assert e["voltages"] == r["voltages"]
        assert e["locked"] == r["locked"]
        assert e["detected"] == {k: int(v) for k, v in r["detected"].items()}
        np.testing.assert_allclose(e["bram_w"], r["bram_w"], rtol=1e-12)
    assert events[0]["voltages"]["mlp"] == pytest.approx(0.60)
    assert events[-1]["voltages"]["mlp"] < 0.60  # the walk is live


def test_rail_policy_with_device_masks_is_read_only(tmp_path):
    plain = _port_trainer(str(tmp_path / "plain"), ckpt_every=100)
    railed = _port_trainer(str(tmp_path / "railed"), ckpt_every=100,
                           rails=RailPolicy(scrub_every=1, start_v=0.60, mask_source="device"))
    assert _losses(plain.run(4)) == _losses(railed.run(4))
    events = [r for r in railed.history if r.get("event") == "rails"]
    assert len(events) == 4 and events[-1]["voltages"]["mlp"] < 0.60


def test_a_mesh_trainer_on_one_rank_is_the_unsharded_trainer(ref_runs, tmp_path):
    """On a one-rank process group, a trainer rescaled onto FSDP shardings
    trains as the unsharded trainer does, bit for bit, its RailPolicy scrub
    (rank 0, gathered params) gives the reference's rail events, a restore
    loads onto its shardings and a rescale back to whole tensors keeps the
    state."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding as tshd
    from repro_torch.launch.mesh import make_host_mesh

    every, steps = RAIL_RUNS[0]
    pol = RailPolicy(scrub_every=every, start_v=0.60)
    plain = _port_trainer(str(tmp_path / "plain"), ckpt_every=100, rails=pol)
    h0 = plain.run(steps)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", world_size=1, rank=0)
    try:
        mesh = make_host_mesh(device="cpu")
        ps = tshd.param_shardings(TCFG, mesh, fsdp=True)
        tr = _port_trainer(str(tmp_path / "mesh"), ckpt_every=2, ecc_checkpoints=True,
                           rails=pol)
        tr.rescale(mesh, ps)
        assert tr.mesh is mesh and tr.param_shardings is ps
        assert isinstance(tr.params["embed"], torch.distributed.tensor.DTensor)
        h1 = tr.run(steps)
        assert _losses(h0) == _losses(h1)
        assert [r for r in h0 if r.get("event")] == [r for r in h1 if r.get("event")]
        ref = [r for r in ref_runs[every] if r.get("event") == "rails"]
        events = [r for r in h1 if r.get("event") == "rails"]
        assert [e["voltages"] for e in events] == [r["voltages"] for r in ref]
        for (_, a), (_, b) in zip(tbase.flatten(plain._state()), tbase.flatten(tr._state())):
            assert torch.equal(a, tshd.gather_leaf(b))
        back = Trainer(TCFG, TC, TokenPipeline(DC), str(tmp_path / "mesh"), mesh=mesh,
                       param_shardings=ps)
        assert back.device == torch.device("cpu") and back.restore() and back.step == steps
        assert isinstance(back.params["embed"], torch.distributed.tensor.DTensor)
        tr.rescale(mesh)
        for (_, a), (_, b) in zip(tbase.flatten(plain._state()), tbase.flatten(tr._state())):
            assert type(b) is torch.Tensor and torch.equal(a, b)
    finally:
        dist.destroy_process_group()


def test_the_trainer_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TCFG, TC, TokenPipeline(DC), str(tmp_path))
