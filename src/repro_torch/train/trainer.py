"""Fault-tolerant training loop.

  * checkpoint/restart — periodic atomic checkpoints (optionally
    SECDED-protected); on a step failure (simulated node fault, non-finite
    loss) the trainer restores the last good checkpoint, falling back to an
    older one past a corrupt one, and replays the deterministic data stream
    from that step;
  * straggler mitigation — per-step wall times feed a median monitor; steps
    slower than ``factor`` x median trigger a pluggable callback;
  * multi-rail undervolting of the weight memory (``RailPolicy``): every
    ``scrub_every`` steps the weights are packed into the SECDED plane
    arena and scrubbed at the controller's per-domain rails, a read path
    that leaves training bitwise unchanged.

  * elastic rescale — ``rescale(new_mesh)`` re-places params and moments
    onto another mesh of the process group, mid-run.

Because batches are a pure function of (seed, step), recovery replays the
exact stream: the loss trajectory after a restore matches an uninterrupted
run. The trainer runs on ``device`` (None: the mesh's device, else the
card) and never moves to another device on its own.

On a mesh (``mesh``, a ``launch.mesh.HostMesh`` over a process group) every
rank runs the trainer on the same pipeline: a step is
``train_step.make_mesh_train_step``'s step (each rank its rows of the
batch over the batch axes, every family tensor- and expert-parallel on
"model" with the leaves gathered over the batch axes only; gradients
averaged over the batch axes, each rank updating its own shards), a save
is collective over the mesh's ranks with rank 0 writing, and ``restore``
loads with the trainer's ``param_shardings``. A trainer without a mesh
saves alone, in a process group or not. As in the reference, the
constructor only stores the mesh and shardings; ``rescale`` places the
state, and a recovery with no checkpoint re-initialises and places it
again. The ``RailPolicy`` scrub
runs on rank 0 alone, over the gathered params, so its rail events are the
unsharded trainer's; the other ranks record none.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels.backend import resolve_device, to_device
from repro_torch.models import base, lm
from repro_torch.models.base import ModelConfig
from repro_torch.optim import adamw
from repro_torch.train.train_step import TrainConfig, make_mesh_train_step, make_train_step


class FaultInjected(RuntimeError):
    """Simulated node failure (tests / chaos drills)."""


@dataclasses.dataclass(frozen=True)
class RailPolicy:
    """Closed-loop multi-rail undervolting of the training weight memory.

    Every ``scrub_every`` steps the trainer packs the current weights into
    the SECDED plane arena (partitioned into memory domains), scrubs it at
    the controller's per-domain rail schedule, and feeds the per-domain
    telemetry back to the MultiRailController — the paper's runtime DED
    canary, driven from inside the training loop. The scrub is a *read*
    path: faults never enter the optimizer state, so loss trajectories are
    bitwise-identical with the policy on or off.
    """

    platform: str = "vc707"
    scrub_every: int = 10
    step_v: float = 0.01
    # gradients amplify silent corruption, so training defaults to paranoid
    paranoid: bool = True
    start_v: float | None = None
    mask_source: str = "host"
    seed: int = 0


@dataclasses.dataclass
class StragglerEvent:
    step: int
    seconds: float
    median: float


class StragglerMonitor:
    """Flags steps slower than ``factor`` x running median (window ``window``)."""

    def __init__(self, factor: float = 3.0, window: int = 20, warmup: int = 3):
        self.factor = factor
        self.window = window
        self.warmup = warmup
        self.times: list[float] = []
        self.events: list[StragglerEvent] = []

    def observe(self, step: int, seconds: float) -> bool:
        slow = False
        if len(self.times) >= self.warmup:
            med = statistics.median(self.times[-self.window:])
            if seconds > self.factor * med:
                self.events.append(StragglerEvent(step, seconds, med))
                slow = True
        self.times.append(seconds)
        return slow


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainConfig,
        pipeline: TokenPipeline,
        ckpt_dir: str,
        *,
        mesh=None,
        param_shardings=None,
        ckpt_every: int = 50,
        ecc_checkpoints: bool = False,
        seed: int = 0,
        fault_hook: Callable[[int], None] | None = None,
        straggler_hook: Callable[[StragglerEvent], None] | None = None,
        rails: RailPolicy | None = None,
        device=None,
    ):
        self.cfg = cfg
        self.tcfg = tcfg
        self.pipeline = pipeline
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.ecc_checkpoints = ecc_checkpoints
        self.fault_hook = fault_hook
        self.straggler = StragglerMonitor()
        self.straggler_hook = straggler_hook
        self.recoveries = 0
        self.history: list[dict] = []
        self.mesh = mesh
        self.param_shardings = param_shardings
        self.device = resolve_device(mesh.device if device is None and mesh is not None
                                     else device)

        self.rails = rails
        self.rail_controller = None  # built on the first scrub (needs domains)
        self.params = lm.init_params(cfg, seed, self.device)
        self.opt_state = adamw.init(self.params, tcfg.optimizer)
        self.step = 0
        self._step_fn = self._make_step()

    def _make_step(self):
        if self.mesh is None:
            return make_train_step(self.cfg, self.tcfg)
        return make_mesh_train_step(self.cfg, self.tcfg, self.mesh)

    def _rank0(self) -> bool:
        import torch.distributed as dist

        return self.mesh is None or dist.get_rank() == 0

    # -- multi-rail weight-memory scrub ---------------------------------------
    def _rail_scrub(self):
        """Pack current weights into the domain arena, scrub at the
        controller's schedule, feed per-domain telemetry back (paper §III.A
        run inside the training loop). Read-only w.r.t. training state."""
        from repro_torch.configs import shapes
        from repro_torch.core import voltage as vmod
        from repro_torch.core.controller import MultiRailController
        from repro_torch.core.planestore import PlaneStore
        from repro_torch.kernels import ops as kops
        from repro_torch.serving.engine import protect_params_inline

        from repro_torch.distributed import sharding as shd

        pol = self.rails
        params = shd.gather(self.params)  # every rank takes part; rank 0 scrubs
        if not self._rank0():
            return
        protected, _ = protect_params_inline(params, self.cfg, include_embed=True)
        leaves, keys = [], []
        for key, leaf in base.flatten(protected):
            if isinstance(leaf, kops.EccWeight):
                leaves.append(leaf)
                keys.append(key)
        if not leaves:
            return
        platform = vmod.PLATFORMS[pol.platform]
        store = PlaneStore(
            leaves, keys, platform, seed=pol.seed,
            mask_source=pol.mask_source, domain_key=shapes.domain_of,
        )
        if self.rail_controller is None:
            self.rail_controller = MultiRailController(
                platform, store.domains, step_v=pol.step_v,
                paranoid=pol.paranoid, start_v=pol.start_v,
            )
        _, dstats = store.set_rails(self.rail_controller.voltages)
        self.rail_controller.update(dstats)
        self.history.append(
            {
                "step": self.step,
                "event": "rails",
                "voltages": dict(self.rail_controller.voltages),
                "locked": self.rail_controller.locked,
                "bram_w": vmod.multi_rail_bram_power(
                    self.rail_controller.voltages, store.words_by_domain()
                ),
                "detected": {d: dstats[d].detected for d in store.domains},
            }
        )

    # -- checkpointing -------------------------------------------------------
    def _state(self):
        return {"params": self.params, "opt": self.opt_state}

    def save(self):
        ckpt.save(
            self.ckpt_dir, self.step, self._state(), ecc_protect=self.ecc_checkpoints,
            group=None if self.mesh is None else self.mesh.group,
        )

    def restore(self, step: int | None = None) -> bool:
        steps = sorted(ckpt.all_steps(self.ckpt_dir))
        if not steps:
            return False
        target = step if step is not None else steps[-1]
        shardings = None
        if self.param_shardings is not None:
            from repro_torch.distributed.sharding import replicated

            ps = self.param_shardings
            shardings = {"params": ps, "opt": {"m": ps, "v": ps,
                                               "step": replicated(self.mesh)}}
        while True:
            try:
                state = ckpt.load(self.ckpt_dir, target, self._state(), shardings=shardings)
                break
            except ckpt.CheckpointCorruption:
                idx = steps.index(target)
                if idx == 0:
                    raise
                target = steps[idx - 1]  # fall back to an older checkpoint
        self.params, self.opt_state = state["params"], state["opt"]
        self.step = target
        return True

    # -- main loop -----------------------------------------------------------
    def run(self, n_steps: int) -> list[dict]:
        end = self.step + n_steps
        while self.step < end:
            t0 = time.time()
            try:
                if self.fault_hook:
                    self.fault_hook(self.step)
                batch = self.pipeline.batch_at(self.step)
                batch = {k: to_device(v, self.device) for k, v in batch.items()}
                self.params, self.opt_state, metrics = self._step_fn(
                    self.params, self.opt_state, batch
                )
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {self.step}")
            except (FaultInjected, FloatingPointError) as e:
                self.recoveries += 1
                restored = self.restore()
                if not restored:
                    # No checkpoint yet: re-init deterministically.
                    self.params = lm.init_params(self.cfg, 0, self.device)
                    self.opt_state = adamw.init(self.params, self.tcfg.optimizer)
                    self.step = 0
                    if self.param_shardings is not None:  # placed as before the fault
                        self.rescale(self.mesh, self.param_shardings)
                self.history.append(
                    {"step": self.step, "event": "recovery", "cause": repr(e)}
                )
                continue

            dt = time.time() - t0
            if self.straggler.observe(self.step, dt) and self.straggler_hook:
                self.straggler_hook(self.straggler.events[-1])
            self.step += 1
            self.history.append({"step": self.step, "loss": loss, "seconds": dt})
            if self.rails is not None and self.step % self.rails.scrub_every == 0:
                self._rail_scrub()
            if self.step % self.ckpt_every == 0:
                self.save()
        return self.history

    # -- elastic -------------------------------------------------------------
    def rescale(self, new_mesh, new_param_shardings=None):
        """Re-place the training state onto ``new_mesh`` (elastic scaling): params
        and moments by ``new_param_shardings``, or whole on every rank (plain
        tensors) without them. The mesh is over the same process group."""
        from repro_torch.distributed import sharding as shd

        self.mesh = new_mesh
        self.param_shardings = new_param_shardings
        self.device = new_mesh.device
        opt = self.opt_state

        def put(tree):
            if new_param_shardings is not None:
                return shd.place(tree, new_param_shardings)
            return base.tree_map(lambda t: t.to(self.device), shd.gather(tree))

        self.params = put(self.params)
        self.opt_state = {"m": put(opt["m"]), "v": put(opt["v"]),
                          "step": shd.gather_leaf(opt["step"]).to(self.device)}
        self._step_fn = self._make_step()
