"""The paper's §IV case study: an NN accelerator whose weights live in
ECC-protected, undervolted on-chip memory (paper Fig. 3).

  * int8 weights packed 8 per 64-bit SECDED codeword (the BRAM geometry);
  * lowering the rail from V_nom toward V_crash injects bit faults into the
    stored planes, check bits included;
  * every inference reads the weights through the SECDED path: the fused
    decode + dequant + matmul kernel, or the naive decode-then-matmul;
  * classification error against voltage, with and without ECC, and the
    calibrated Table-I power model reproduce paper Fig. 3.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import voltage as vmod
from repro_torch.core.faultsim import FaultField, device_masks
from repro_torch.core.planestore import PlaneStore, inject_leaf, leaf_seed
from repro_torch.core.telemetry import FaultStats
from repro_torch.kernels import ops as kops
from repro_torch.kernels.backend import resolve_device, to_device


@dataclasses.dataclass
class _Layer:
    w: torch.Tensor  # float32 trained weight (K, N)
    b: torch.Tensor  # float32 bias (N,)
    enc: kops.EccWeight | None = None  # clean encoded planes
    faulty: kops.EccWeight | None = None  # planes at the current rail voltage
    field: FaultField | None = None


class EccMLP:
    """MLP classifier with SECDED-protected int8 weights (the paper's
    accelerator). ``mask_source`` ("host" or "device") feeds the batched
    step's plane store; the per-leaf step keeps its host fields.
    ``device=None`` runs on the card and raises without one."""

    def __init__(self, layer_sizes, platform: str = "vc707", seed: int = 0,
                 mask_source: str = "host", device=None):
        if mask_source not in ("host", "device"):
            raise ValueError(f"mask_source must be 'host' or 'device', got {mask_source!r}")
        self.sizes = tuple(layer_sizes)
        self.platform = vmod.PLATFORMS[platform]
        self.seed = seed
        self.mask_source = mask_source
        self.device = resolve_device(device)
        self.voltage = self.platform.v_nom
        self.ecc_enabled = True
        self.stats = FaultStats()
        # Drawn on the host generator, so every device starts from the same
        # weights.
        gen = torch.Generator().manual_seed(int(seed))
        self.layers: list[_Layer] = []
        for k, n in zip(self.sizes[:-1], self.sizes[1:]):
            w = torch.randn(k, n, generator=gen) * (2.0 / math.sqrt(k))
            self.layers.append(_Layer(w=w.to(self.device), b=torch.zeros(n, device=self.device)))

    def load_params(self, params) -> None:
        """Set the float weights from [(w (K, N), b (N,)), ...] arrays."""
        assert len(params) == len(self.layers), (len(params), len(self.layers))
        for layer, (w, b) in zip(self.layers, params):
            layer.w = torch.from_numpy(np.array(w, np.float32)).to(self.device)
            layer.b = torch.from_numpy(np.array(b, np.float32)).to(self.device)

    # -- float training -------------------------------------------------------
    def _forward_f32(self, params, x):
        h = x
        for i, (w, b) in enumerate(params):
            h = h @ w + b
            if i < len(self.sizes) - 2:
                h = torch.relu(h)
        return h

    def train(self, xs, ys, steps=600, batch=128, lr=3e-3, seed=0) -> float:
        """Plain SGD on the mean cross-entropy; batches drawn by the numpy
        Philox stream (seed, 0x7281). Ends by storing the weights."""
        params = [(l.w.clone().requires_grad_(), l.b.clone().requires_grad_())
                  for l in self.layers]
        flat = [p for wb in params for p in wb]
        xs_d = torch.as_tensor(np.asarray(xs, np.float32)).to(self.device)
        ys_d = torch.as_tensor(np.asarray(ys)).to(self.device, torch.int64)
        rng = np.random.Generator(np.random.Philox(key=(seed, 0x7281)))
        n = xs_d.shape[0]
        loss = None
        for _ in range(steps):
            idx = to_device(rng.integers(0, n, size=batch), self.device)
            xb, yb = xs_d[idx], ys_d[idx]
            logits = self._forward_f32(params, xb)
            gold = logits.gather(1, yb[:, None])[:, 0]
            loss = torch.mean(torch.logsumexp(logits, dim=-1) - gold)
            grads = torch.autograd.grad(loss, flat)
            with torch.no_grad():
                for p, g in zip(flat, grads):
                    p.sub_(lr * g)
        for l, (w, b) in zip(self.layers, params):
            l.w, l.b = w.detach(), b.detach()
        self.store()
        return float(loss.detach())

    # -- memory domain ---------------------------------------------------------
    def store(self) -> None:
        """Quantize the weights to int8 and SECDED-encode them (write to the
        BRAM), then re-apply the current rail."""
        for i, l in enumerate(self.layers):
            l.enc = kops.pack_ecc_weights(l.w)
            l.field = FaultField(self.platform, l.enc.lo.numel(),
                                 seed=leaf_seed(self.seed, f"layer{i}"))
        self._store = PlaneStore(
            [l.enc for l in self.layers], [f"layer{i}" for i in range(len(self.layers))],
            self.platform, seed=self.seed, mask_source=self.mask_source, device=self.device,
        )
        self.set_voltage(self.voltage, self.ecc_enabled)

    def set_voltage(self, v: float, ecc: bool = True, batched: bool = True) -> None:
        """Move the rail and make the faulty view of every plane.

        batched=True : one fused inject+scrub launch over the whole arena;
        batched=False: the per-leaf reference loop (inject, re-encode without
                       ECC, scrub: one launch each per layer), bit-identical."""
        self.voltage = float(v)
        self.ecc_enabled = ecc
        if batched:
            leaves, stats = self._store.set_voltage(v, ecc=ecc)
            for l, faulty in zip(self.layers, leaves):
                l.faulty = faulty
            self.stats = stats
            return
        agg = FaultStats()
        for l in self.layers:
            l.faulty, stats = inject_leaf(
                l.enc, device_masks(l.field, v, self.device, l.enc.lo.shape), ecc
            )
            agg.accumulate(stats)
        self.stats = agg

    # -- inference through the ECC read path -----------------------------------
    @torch.no_grad()
    def logits(self, xs, fuse: bool = True) -> torch.Tensor:
        """Float32 logits (B, classes) of ``xs`` through the faulty planes."""
        h = torch.as_tensor(np.asarray(xs, np.float32)).to(self.device)
        for i, l in enumerate(self.layers):
            h = kops.ecc_matmul(h, l.faulty, fuse=fuse) + l.b
            if i < len(self.sizes) - 2:
                h = torch.relu(h)
        return h

    def predict(self, xs, fuse: bool = True) -> np.ndarray:
        return torch.argmax(self.logits(xs, fuse=fuse), dim=-1).cpu().numpy()

    def error_rate(self, xs, ys, fuse: bool = True) -> float:
        pred = self.predict(xs, fuse=fuse)
        return float((pred != np.asarray(ys)).mean())

    def power_w(self) -> float:
        return vmod.accelerator_power(self.voltage, ecc=self.ecc_enabled)

    def bram_power_w(self) -> float:
        return vmod.bram_power(self.voltage, ecc=self.ecc_enabled)
