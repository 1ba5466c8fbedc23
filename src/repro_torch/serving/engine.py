"""Serving engine with ECC-protected weights under an undervolted rail.

Domain mode (the default): the raw bits of every parameter are stored in an
``EccMemoryDomain`` on the card; every voltage step reads the whole tree
back through fault injection and SECDED decode, and the forward runs the
read-back (plain, dense) parameters.

Inline mode: every attention/MLP matrix (and, for multi-rail engines, the
embedding) is int8-quantized and packed into word planes held in one
``PlaneStore`` arena on the card, each memory domain under its own ECC codec
(``ProtectionConfig.codecs``; SECDED(72,64) by default). A voltage step is
one fused inject+scrub launch per codec group whose counters feed the
DED-canary controller; every forward pass reads the faulty planes through
the fused decode + dequant + matmul kernel, which reads SECDED planes. So
when its rail moves, a leaf under another codec is decoded under its codec
and its corrected words re-encoded as SECDED planes (refresh), and the
embedding, read by gather rather than matmul, is decoded into a float
table. Power comes from the calibrated Table-I model, weighted by each
domain's check bits.

``serve`` drives a stream of variable-length requests through continuous
batching over a paged KV cache held in ECC pages (the `kv` domain's codec)
on the `kv` voltage domain (core/kvpages.py, serving/scheduler.py).

A mesh engine (``mesh=``, a ``launch.mesh.ReliabilityMesh``; inline,
multi-rail, device masks) treats every reliability shard as its own chip:
its own fault stream over its slice of the plane arena, its own rails
(``MeshRailController``: ``uniform`` locks one schedule at the worst
shard's first DED, ``per_shard`` walks every chip to its own V_min), its own
KV arena and its own share of a served stream. The forward stays on one
device, as in the reference's engine.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import codes
from repro_torch.configs import shapes
from repro_torch.core import campaign, scenario
from repro_torch.core import voltage as vmod
from repro_torch.core.controller import (
    EscalationPolicy,
    MeshRailController,
    MultiRailController,
    UndervoltController,
)
from repro_torch.core.faultsim import FaultField, device_masks, gather_masks
from repro_torch.core.kvpages import PAGE_TOKENS, KVGeometry, KVPageArena
from repro_torch.core.memory import EccMemoryDomain
from repro_torch.core.planestore import PlaneStore, inject_leaf, leaf_seed
from repro_torch.core.telemetry import DomainFaultStats, FaultStats, ShardFaultStats
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import base, lm
from repro_torch.models.base import ModelConfig
from repro_torch.serving import scheduler as sched
from repro_torch.serving import steps as serve_steps


class ReliabilityConfigError(ValueError, AssertionError):
    """An invalid or not yet ported reliability-config combination."""


@dataclasses.dataclass(frozen=True)
class FaultModelConfig:
    """How faults are generated and applied. ``mask_source="device"`` draws
    the inline batched arena's masks on the device (``DeviceFaultField``);
    domain mode and the per-leaf path keep host fields, as in the
    reference. ``environment`` (None, a name of ``scenario.ENVIRONMENTS`` or
    an ``EnvironmentProfile``) and ``drift`` (its aging sigma; alone, a
    neutral environment) reach the batched arena and the paged KV cache; as
    in the reference, the per-leaf path, domain mode and the single-rail
    controller ignore them."""

    mask_source: str = "host"  # "host": NumPy FaultField masks; "device"
    batched: bool = True  # one fused launch over the whole arena; False: per leaf
    environment: Any = None
    drift: float | None = None


@dataclasses.dataclass(frozen=True)
class RailsConfig:
    """Voltage-rail topology and controller tuning."""

    multi_rail: bool = False
    # mesh engines: "uniform" locks one schedule at the worst shard's first
    # DED; "per_shard" walks every chip to its own V_min
    policy: str = "uniform"
    spread: float = 0.0  # > 0: per-domain fault-curve variation
    step_v: float = 0.01
    start_v: float | None = None  # warm start of the canary search
    adaptive: bool = False


@dataclasses.dataclass(frozen=True)
class ProtectionConfig:
    """Which memories are protected and under which ECC scheme."""

    codecs: Any = None  # None, a registered codec name, or {domain: name} (multi-rail)
    # EscalationPolicy or a tuple of codec names, weakest -> strongest
    # (multi-rail engines; a single-rail engine ignores it)
    escalation: Any = None
    embed: bool | None = None  # None -> multi_rail


@dataclasses.dataclass(frozen=True)
class CanaryConfig:
    """DED and accuracy canary behaviour."""

    prompts: int = 0  # > 0: this many fixed canary prompts per autotune round
    tokens: int = 12  # greedy tokens decoded per canary prompt
    # a canary divergence above this trips the rail with clean DED counters;
    # None records the score and never trips
    divergence_slo: float | None = None
    paranoid: bool = False  # silent (ground-truth) events trip too


@dataclasses.dataclass(frozen=True)
class ReliabilityConfig:
    """Reliability knobs of a ServingEngine, grouped in four sub-configs.
    ``validate()`` rejects contradictory combinations and the parts not yet
    ported."""

    platform: str = "vc707"
    ecc: bool = True
    voltage: float | None = None  # None -> nominal
    mode: str = "domain"  # "domain" | "inline"
    seed: int = 0
    fault_model: FaultModelConfig = dataclasses.field(default_factory=FaultModelConfig)
    rails: RailsConfig = dataclasses.field(default_factory=RailsConfig)
    protection: ProtectionConfig = dataclasses.field(default_factory=ProtectionConfig)
    canary: CanaryConfig = dataclasses.field(default_factory=CanaryConfig)

    def validate(self, *, mesh=None) -> "ReliabilityConfig":
        """Raise ReliabilityConfigError on an invalid or unported
        combination; returns ``self``. ``mesh`` adds the mesh engine's
        constraints."""

        def _require(cond: bool, msg: str):
            if not cond:
                raise ReliabilityConfigError(msg)

        fm, prot, multi = self.fault_model, self.protection, self.rails.multi_rail
        _require(
            self.mode in ("domain", "inline"),
            f"mode must be 'domain' or 'inline', got {self.mode!r}",
        )
        _require(self.platform in vmod.PLATFORMS, f"unknown platform {self.platform!r}")
        if self.mode == "domain":
            _require(
                prot.codecs in (None, "secded72"),
                "domain mode stores raw bits behind the built-in SECDED; "
                "codec selection needs mode='inline'",
            )
            _require(not multi, "domain mode has one rail; multi_rail needs mode='inline'")
        else:
            _require(not multi or fm.batched, "multi_rail drives the batched plane arena")
            _require(
                fm.batched or prot.codecs in (None, "secded72"),
                "the per-leaf reference path is SECDED-only; codec selection needs "
                "the batched arena",
            )
        try:
            shapes.rail_policy(self.rails.policy)
        except AssertionError as e:
            raise ReliabilityConfigError(str(e)) from None
        if mesh is not None:
            _require(
                multi and self.mode == "inline",
                "mesh engines drive the multi-rail batched plane arena",
            )
            _require(
                fm.mask_source == "device",
                "mesh engines need device masks (the per-shard streams live on the device)",
            )
            _require(
                self.rails.policy == "uniform" or prot.escalation is None,
                "per-shard codec escalation needs per-shard plane groups; use "
                "policy='uniform' with an escalation ladder",
            )
        _require(
            fm.mask_source in ("host", "device"),
            f"mask_source must be 'host' or 'device', got {fm.mask_source!r}",
        )
        _require(
            fm.environment is None or isinstance(fm.environment, scenario.EnvironmentProfile)
            or (isinstance(fm.environment, str) and fm.environment in scenario.ENVIRONMENTS),
            f"unknown environment {fm.environment!r}; known: {sorted(scenario.ENVIRONMENTS)}",
        )
        codecs = (
            [prot.codecs] if isinstance(prot.codecs, str)
            else list(dict(prot.codecs).values()) if prot.codecs is not None else []
        )
        _require(
            all(c in codes.names() for c in codecs),
            f"unknown codec in {prot.codecs!r}; registered: {codes.names()}",
        )
        _require(
            multi or prot.codecs is None or isinstance(prot.codecs, str),
            "per-domain codec dicts need multi_rail=True",
        )
        _require(
            self.canary.prompts == 0 or self.mode == "inline",
            "the accuracy canary decodes against the clean inline plane templates; "
            "it needs mode='inline'",
        )
        return self

    @property
    def embed_protected(self) -> bool:
        embed = self.protection.embed
        return self.rails.multi_rail if embed is None else embed

    @property
    def environment_profile(self) -> scenario.EnvironmentProfile | None:
        return scenario.resolve(self.fault_model.environment, drift=self.fault_model.drift)

    @property
    def escalation_policy(self) -> EscalationPolicy | None:
        esc = self.protection.escalation
        if esc is None or isinstance(esc, EscalationPolicy):
            return esc
        return EscalationPolicy(ladder=tuple(esc))


def _decode_gather_table(ew: kops.EccWeight, codec: str = "secded72") -> torch.Tensor:
    """ECC-read an EccWeight into its dequantized float (K, N) table (the
    embedding, read by gather, is refreshed this way when its rail moves)."""
    lo, hi, _ = kops.decode(ew.lo, ew.hi, ew.parity, codec=codec)
    if lo.ndim == 3:  # layer-stacked (G, K/8, N)
        w_i8 = torch.stack([kref.unpack_ecc_weights(lo[g], hi[g]) for g in range(lo.shape[0])])
        return w_i8.to(torch.float32) * ew.scale[:, None, :]
    return kref.unpack_ecc_weights(lo, hi).to(torch.float32) * ew.scale


def _refresh_secded(ew: kops.EccWeight, codec: str) -> kops.EccWeight:
    """A faulty leaf under ``codec`` as the SECDED planes the fused matmul
    reads: decode under its codec (one decode launch), re-encode the
    corrected words under SECDED (one encode launch). Its syndromes are then
    0, so the matmul's weights are the decoded int8 words times the scale,
    the values the reference's decoded float table holds, and the matmul
    keeps its one K-sum order (rows do not depend on the batch)."""
    lo, hi, _ = kops.decode(ew.lo, ew.hi, ew.parity, codec=codec)
    return dataclasses.replace(ew, lo=lo, hi=hi, parity=kops.encode(lo, hi))


def _pack_stacked(leaf) -> kops.EccWeight:
    """Pack a layer-stacked (G, K, N) weight into stacked ECC planes."""
    packed = [kops.pack_ecc_weights(leaf[i].to(torch.float32)) for i in range(leaf.shape[0])]
    return kops.EccWeight(
        lo=torch.stack([p.lo for p in packed]),
        hi=torch.stack([p.hi for p in packed]),
        parity=torch.stack([p.parity for p in packed]),
        scale=torch.stack([p.scale for p in packed]),
        k=packed[0].k,
        n=packed[0].n,
    )


def protect_params_inline(params, cfg: ModelConfig, include_embed: bool = False):
    """Replace weight matrices (K % 8 == 0) with SECDED int8 EccWeight planes.

    Handles plain (K, N) and layer-stacked (G, K, N) leaves. Returns
    (new_params, {key: word count}). ``include_embed`` adds the embedding
    table (multi-rail engines protect it as its own domain)."""
    out, fields = [], {}
    for key, leaf in base.flatten(params):
        wanted = "attn" in key or "mlp" in key or (include_embed and "embed" in key)
        if not isinstance(leaf, torch.Tensor) or not wanted:
            out.append(leaf)
            continue
        if leaf.ndim == 2 and leaf.shape[0] % 8 == 0 and min(leaf.shape) >= 64:
            ew = kops.pack_ecc_weights(leaf.to(torch.float32))
        elif leaf.ndim == 3 and leaf.shape[1] % 8 == 0 and min(leaf.shape[1:]) >= 64:
            ew = _pack_stacked(leaf)
        else:
            out.append(leaf)
            continue
        out.append(ew)
        fields[key] = ew.lo.numel()
    return base.unflatten(params, out), fields


class ServingEngine:
    """Greedy-decoding engine over ECC-protected weights on one device.

    ``device=None`` runs on the card and raises without one; the tests pass
    ``device="cpu"``, which runs every kernel's plain version. An optional
    flight recorder (``recorder``, obs.TraceRecorder) gets every rail
    decision and serve-loop event in one causally ordered, deterministic
    trace; it only reads values the host already holds. ``mesh`` (a
    ``ReliabilityMesh``) makes a mesh engine: then ``device=None`` is the
    device of shard 0, every shard must be on a device of that type, and
    ``rails`` holds one {domain: voltage} dict per shard."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        rel: ReliabilityConfig | None = None,
        max_len: int = 512,
        device=None,
        recorder=None,
        mesh=None,
    ):
        lm.check_family(cfg)
        self.cfg = cfg
        self.rel = rel
        self.max_len = max_len
        self.recorder = recorder
        self.mesh = mesh
        self.device = resolve_device(
            mesh.device_of(0) if device is None and mesh is not None else device)
        if rel is not None:
            rel.validate(mesh=mesh)
        elif mesh is not None:
            raise ReliabilityConfigError(
                "mesh engines drive the multi-rail batched plane arena (a ReliabilityConfig "
                "is required)")
        if mesh is not None:
            kinds = {mesh.device_of(s).type for s in range(mesh.shape["data"])}
            if kinds != {self.device.type}:
                raise ValueError(f"mesh shards on {sorted(kinds)} and the engine on "
                                 f"{self.device.type}: every shard runs on the engine's kind "
                                 "of device")
        params = base.tree_map(lambda t: t.to(self.device), params)
        self.platform = vmod.PLATFORMS[rel.platform] if rel else None
        rails = rel.rails if rel else None
        self.controller = (
            UndervoltController(
                self.platform,
                step_v=rails.step_v,
                paranoid=rel.canary.paranoid,
                start_v=rails.start_v,
                divergence_slo=rel.canary.divergence_slo,
            )
            if rel and not rails.multi_rail
            else None
        )
        self.rails = None  # {domain: voltage} on multi-rail engines; one per shard on a mesh
        self.rail_stats = DomainFaultStats()
        self.shard_stats = ShardFaultStats()  # cumulative per-shard rows (mesh)
        self.stats = FaultStats()
        self._last_scrub = None
        self._canary_ref = None  # the clean canary rollout, made on first use
        self.kv_arena = None
        self.kv_arenas = None  # one per shard after a mesh serve
        self._paged_helper_cache: dict = {}
        self.domain = None
        if rel is None:
            self.params = params
            return
        if recorder is not None and self.controller is not None:
            self.controller.bind_recorder(recorder)  # single-rail (multi-rail: where built)
        if rel.mode == "domain":
            self.domain = EccMemoryDomain(
                self.platform, seed=rel.seed, ecc_enabled=rel.ecc,
                voltage=rel.voltage or 1.0, device=self.device,
            )
            self.domain.write_pytree("w", params)
            self._clean_params = params
            self.params = params  # replaced by every set_voltage's read-back
            self.set_voltage(self.domain.voltage)
            return
        clean, _ = protect_params_inline(params, cfg, include_embed=rel.embed_protected)
        self._inline_tree = clean
        flat = base.flatten(clean)
        self._inline_template = [leaf for _, leaf in flat]
        self._ecc_slots = [
            (i, key) for i, (key, leaf) in enumerate(flat) if isinstance(leaf, kops.EccWeight)
        ]
        self._fields: dict[str, FaultField] = {}  # per-leaf path, made on first use
        rail_profiles = (
            vmod.derive_domain_profiles(
                self.platform, shapes.MEMORY_DOMAINS, spread=rails.spread, seed=rel.seed
            )
            if rails.multi_rail and rails.spread > 0
            else None
        )
        codecs = rel.protection.codecs
        self._store = PlaneStore(
            [self._inline_template[i] for i, _ in self._ecc_slots],
            [key for _, key in self._ecc_slots],
            self.platform,
            seed=rel.seed,
            mask_source=rel.fault_model.mask_source,
            domain_key=shapes.domain_of if rails.multi_rail else None,
            profiles=rail_profiles,
            codecs=shapes.domain_codecs(codecs) if rails.multi_rail else codecs,
            device=self.device,
            env=rel.environment_profile,
            mesh=mesh,
        )
        self.voltage = rel.voltage or self.platform.v_nom
        if rails.multi_rail:
            rail_kw = dict(
                step_v=rails.step_v,
                paranoid=rel.canary.paranoid,
                start_v=rails.start_v,
                profiles={d: self._store.domain_profile(d) for d in self._store.domains},
                escalation=rel.escalation_policy,
                codecs={d: self._store.codec_of(d) for d in self._store.domains},
                adaptive=rails.adaptive,
                divergence_slo=rel.canary.divergence_slo,
            )
            if mesh is not None:
                self.controller = MeshRailController(
                    self.platform, self._store.domains, self._store.n_shards,
                    policy=rails.policy, **rail_kw)
            else:
                self.controller = MultiRailController(self.platform, self._store.domains,
                                                      **rail_kw)
            self.set_rails({d: self.voltage for d in self._store.domains})
            if recorder is not None:
                self.controller.bind_recorder(recorder)
        else:
            self.set_voltage(self.voltage)

    # -- voltage control ------------------------------------------------------
    def set_voltage(self, v: float):
        """Move the whole rail to ``v``: one fused inject+scrub launch (the
        per-leaf path: one inject and one scrub per leaf; domain mode: a
        read of the whole parameter tree)."""
        self.voltage = float(v)
        if self.rel is None:
            return
        if self.rel.rails.multi_rail:
            self.set_rails({d: float(v) for d in self._store.domains})
            return
        if self.rel.mode == "domain":
            self.domain.set_voltage(v)
            self.params, stats = self.domain.read_pytree("w", self._clean_params)
            self.stats.accumulate(stats)
            return
        if not self.rel.fault_model.batched:
            self._apply_inline_faults(v)
            return
        leaves, stats = self._store.set_voltage(v, ecc=self.rel.ecc)
        self.params = self._reassemble_params(leaves)
        self.stats.accumulate(stats)
        self._last_scrub = stats

    def _apply_inline_faults(self, v: float):
        """Per-leaf reference path: every protected leaf takes its own
        ``inject_leaf`` step, its masks from its own field keyed by its
        path. The masks of all leaves are drawn first, together, on a pool
        of threads."""
        fields = []
        for i, key in self._ecc_slots:
            if key not in self._fields:
                self._fields[key] = FaultField(
                    self.platform, self._inline_template[i].lo.numel(),
                    seed=leaf_seed(self.rel.seed, key),
                )
            fields.append(self._fields[key])
        if self.platform.fault_rate(float(v)) > 0.0:
            gather_masks([(f, v) for f in fields])
        flat = list(self._inline_template)
        agg = FaultStats()
        for (i, key), field in zip(self._ecc_slots, fields):
            masks = device_masks(field, v, self.device, flat[i].lo.shape)
            faulty, stats = inject_leaf(flat[i], masks, self.rel.ecc)
            agg.accumulate(stats)
            flat[i] = _decode_gather_table(faulty) if "embed" in key else faulty
        self.params = base.unflatten(self._inline_tree, flat)
        self.stats.accumulate(agg)
        self._last_scrub = agg

    def set_rails(self, volts):
        """Per-domain voltage step (multi-rail engines): one fused launch,
        one counter row per domain. Rails ``volts`` does not name (the `kv`
        rail) keep their voltage. A mesh engine takes any schedule form of
        ``PlaneStore._normalize_schedule`` (one dict, one per shard, or
        per-shard values) and steps every shard (``_set_rails_mesh``)."""
        assert self.rel is not None and self.rel.rails.multi_rail
        if self.mesh is not None:
            return self._set_rails_mesh(volts)
        new = {d: float(v) for d, v in volts.items()}
        self.rails = {**self.rails, **new} if self.rails else new
        self.voltage = max(self.rails.values())
        leaves, dstats = self._store.set_rails(self.rails, ecc=self.rel.ecc)
        self.params = self._reassemble_params(leaves)
        self.rail_stats.accumulate(dstats)
        self.stats.accumulate(dstats.total())
        self._last_scrub = dstats

    def _set_rails_mesh(self, volts):
        """Mesh rail step: every shard at its own schedule, per codec group
        one field and one B2 launch a shard (``set_rails_sharded``)."""
        schedule = self._store._normalize_schedule(volts)
        if self.rails:
            schedule = [{**old, **{d: float(v) for d, v in new.items()}}
                        for old, new in zip(self.rails, schedule)]
        else:
            schedule = [{d: float(v) for d, v in s.items()} for s in schedule]
        self.rails = schedule
        self.voltage = max(v for s in schedule for v in s.values())
        leaves, sstats = self._store.set_rails_sharded(schedule, ecc=self.rel.ecc)
        self.params = self._reassemble_params(leaves)
        self.shard_stats.accumulate(sstats)
        reduced = sstats.reduced()
        self.rail_stats.accumulate(reduced)
        self.stats.accumulate(reduced.total())
        self._last_scrub = sstats

    def _leaf_codec(self, key: str) -> str:
        return self._store.codec_of(next(s.domain for s in self._store.slots if s.key == key))

    def _reassemble_params(self, leaves):
        """Faulty arena slices back into the parameter tree. The embedding is
        decoded under its codec into its float table; any other leaf under a
        codec other than SECDED is refreshed (``_refresh_secded``), so the
        fused matmul reads it."""
        flat = list(self._inline_template)
        for (i, key), leaf in zip(self._ecc_slots, leaves):
            codec = self._leaf_codec(key)
            if "embed" in key:
                flat[i] = _decode_gather_table(leaf, codec=codec)
            elif codec != codes.DEFAULT_CODEC:
                flat[i] = _refresh_secded(leaf, codec)
            else:
                flat[i] = leaf
        return base.unflatten(self._inline_tree, flat)

    # -- serving --------------------------------------------------------------
    @torch.no_grad()
    def generate(self, prompts: np.ndarray, n_tokens: int, *, params=None) -> np.ndarray:
        """Greedy-decode a batch: prompts (B, S0) int -> tokens (B, n). A vlm
        (no image) and an audio config ((B, K, S) tokens) are refused, as the
        reference fails on them; so are the canary and ``serve``, which
        decode through this path or the paged one."""
        if self.cfg.family == "vlm" or self.cfg.n_codebooks:
            raise ValueError(f"{self.cfg.name}: generate takes (B, S) prompts and no image; "
                             "drive this family through lm.prefill / lm.decode_step or "
                             "serving.steps.make_prefill_step / make_serve_step")
        p = self.params if params is None else params
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int64, device=self.device)
        b, s0 = toks.shape
        cache = lm.init_cache(self.cfg, b, self.max_len, device=self.device)
        logits, cache = lm.prefill(p, toks, self.cfg, cache)
        tok = torch.argmax(logits, dim=-1)[:, None]
        rest, _ = lm.greedy_decode_loop(p, tok, self.cfg, cache, s0, n_tokens - 1)
        return torch.cat([tok, rest], dim=1).cpu().numpy().astype(np.int32)

    # -- accuracy canary ----------------------------------------------------------
    def canary_divergence(self) -> float | None:
        """Greedy-decode the canary prompts at the current rails and score
        them against the clean rollout: ``1 - mean(matched prefix
        fraction)`` in [0, 1], exactly 0.0 when every continuation equals
        the clean one; None when the canary is off (``canary.prompts`` 0).
        The clean rollout is decoded once, on first use, from the clean
        plane templates through the same quantized read path, so
        quantization cancels and only injected faults score."""
        if self.rel is None or not self.rel.canary.prompts:
            return None
        prompts = campaign.eval_prompts(self.cfg.vocab, self.rel.canary.prompts,
                                        campaign.CANARY_PROMPT_LEN, seed=self.rel.seed ^ 0xACC)
        if self._canary_ref is None:
            clean = self._reassemble_params(
                [self._inline_template[i] for i, _ in self._ecc_slots])
            self._canary_ref = self.generate(prompts, self.rel.canary.tokens, params=clean)
        div = campaign.token_divergence(self._canary_ref,
                                        self.generate(prompts, self.rel.canary.tokens))
        if self.recorder:
            self.recorder.emit("canary_probe", divergence=float(div))
        return div

    # -- continuous batching over the paged ECC KV cache ------------------------
    @torch.no_grad()
    def serve(
        self,
        requests,
        *,
        n_lanes: int = 4,
        page_tokens: int = PAGE_TOKENS,
        n_pages: int | None = None,
        scrub_interval: int = 1,
        max_block: int = 16,
        kv_voltage: float | None = None,
        walk_kv: bool = False,
        share_prefix: bool = False,
        speculative: int = 0,
        draft_params=None,
        draft_cfg: ModelConfig | None = None,
        scrub_overlap: bool | None = None,
    ) -> sched.ServeReport:
        """Serve a stream of variable-length requests.

        ``requests``: (prompt (s0,) int, max_new_tokens) pairs or
        ``scheduler.Request`` objects. The KV cache lives in ECC pages (the
        `kv` domain's codec) on the `kv` voltage domain and every read
        scrubs; at nominal voltage the tokens equal ``generate``'s on the same batch composition.
        ``share_prefix`` shares full-page prompt prefixes between requests;
        ``speculative=K`` (K >= 2, with ``draft_params``/``draft_cfg``)
        verifies K-1 drafted tokens per block; ``walk_kv`` (multi-rail
        engines) attaches a `kv` rail to the controller and walks it on the
        interval scrubs' DED counters; under an escalation ladder the rail
        may step up the arena's code mid-stream, and a later serve starts
        under the code the rail reached. ``scrub_overlap`` (None: overlap
        unless escalation is live; True: defer each interval's counter
        harvest to the next interval; False: serialized) changes no result.
        The cache arena stays on ``self.kv_arena``; its counters join
        ``stats`` and ``rail_stats`` and its words, under the arena's final
        code, the power accounting.

        A mesh engine serves the stream data-parallel (``_serve_mesh``) and
        returns a ``scheduler.MeshServeReport``."""
        if not shapes.supports_paged_kv(self.cfg):
            raise ValueError(f"{self.cfg.name}: paged KV unsupported (see "
                             "shapes.supports_paged_kv)")
        if int(speculative) >= 2:
            assert draft_params is not None and draft_cfg is not None, (
                "speculative decode needs draft_params + draft_cfg"
            )
        else:
            draft_params = draft_cfg = None
        if self.mesh is not None:
            return self._serve_mesh(
                requests, n_lanes=n_lanes, page_tokens=page_tokens, n_pages=n_pages,
                scrub_interval=scrub_interval, max_block=max_block, kv_voltage=kv_voltage,
                walk_kv=walk_kv, share_prefix=share_prefix, speculative=speculative,
                draft_params=draft_params, draft_cfg=draft_cfg, scrub_overlap=scrub_overlap,
            )
        profile = self.platform or vmod.PLATFORMS["vc707"]
        envp = self.rel.environment_profile if self.rel is not None else None
        if self.rel is not None and self.rel.rails.multi_rail:
            profile = self._store.domain_profile("kv")  # the flux is in it
        elif envp is not None:
            profile = envp.scale_profile(profile)
        geom = KVGeometry.from_config(self.cfg, page_tokens)
        if n_pages is None:
            n_pages = n_lanes * geom.pages_for(self.max_len)
        kv_codec = (
            shapes.domain_codecs(self.rel.protection.codecs)["kv"]
            if self.rel is not None
            else shapes.DEFAULT_CODEC
        )
        if walk_kv and self.controller is not None:
            rail = getattr(self.controller, "rails", {}).get("kv")
            if rail is not None:
                # An earlier serve's escalation persists: the fresh arena is
                # protected under the code the rail reached.
                kv_codec = rail.codec
        arena = KVPageArena(
            geom, profile, n_pages,
            seed=self.rel.seed if self.rel else 0,
            ecc=self.rel.ecc if self.rel else True,
            codec=kv_codec,
            device=self.device,
            env=envp,
        )
        if kv_voltage is None:
            if self.rails is not None and "kv" in self.rails:
                kv_voltage = self.rails["kv"]
            elif self.rel is not None:
                kv_voltage = self.voltage
            else:
                kv_voltage = profile.v_nom
        arena.set_voltage(float(kv_voltage))
        kv_controller = None
        if walk_kv:
            assert self.rel is not None and self.rel.rails.multi_rail, (
                "walk_kv needs a multi-rail engine"
            )
            kv_controller = self.controller.add_rail("kv", profile, codec=kv_codec)
            # The controller is the source of truth for the walked rail: the
            # first interval injects at the voltage its canary judges.
            arena.set_voltage(kv_controller.voltage)
        helpers = self._paged_helpers(geom, kv_codec, draft_cfg=draft_cfg)
        report = sched.serve_stream(
            self.params, self.cfg, helpers, arena, requests,
            n_lanes=n_lanes, max_len=self.max_len, scrub_interval=scrub_interval,
            max_block=max_block, kv_controller=kv_controller,
            init_cache_fn=lambda b: lm.init_cache(self.cfg, b, self.max_len, device=self.device),
            # an escalation rebuilds the speculative helpers too
            helpers_factory=lambda cname: self._paged_helpers(geom, cname, draft_cfg=draft_cfg),
            share_prefix=share_prefix, speculative=speculative,
            draft_params=draft_params, draft_cfg=draft_cfg, recorder=self.recorder,
            scrub_overlap=scrub_overlap,
        )
        # The kv domain now has real words (power weighting) and counters.
        self.stats.accumulate(report.kv_stats)
        self.rail_stats.accumulate(DomainFaultStats({"kv": report.kv_stats}))
        if self.rel is not None and self.rel.mode == "inline":
            self._store.register_domain_words("kv", arena.n_words, codec=arena.codec_name)
        if self.rails is not None:
            self.rails["kv"] = arena.voltage
        self.kv_arena = arena
        return report

    def _serve_mesh(self, requests, *, n_lanes: int, page_tokens: int, n_pages: int | None,
                    scrub_interval: int, max_block: int, kv_voltage: float | None,
                    walk_kv: bool, share_prefix: bool, speculative: int, draft_params,
                    draft_cfg: ModelConfig | None,
                    scrub_overlap: bool | None) -> sched.MeshServeReport:
        """Data-parallel continuous batching across the reliability shards:
        the stream dealt round-robin (``partition_requests``), and each
        shard's part served over the shard's own KV arena
        (``KVPageArena(shard=s)``: its own fault stream, and under
        ``per_shard`` rails its own `kv` rail). Under ``uniform`` one shared
        kv rail walks through every shard's part in turn, so its canary sees
        every chip's DED events. The arenas live on the engine's device,
        where the forward runs."""
        geom = KVGeometry.from_config(self.cfg, page_tokens)
        if n_pages is None:
            n_pages = n_lanes * geom.pages_for(self.max_len)
        profile = self._store.domain_profile("kv")
        n_shards = self._store.n_shards
        parts = sched.partition_requests(sched.normalize_requests(requests), n_shards)
        base_codec = shapes.domain_codecs(self.rel.protection.codecs)["kv"]
        kv_rails = (self.controller.add_rail("kv", profile, codec=base_codec) if walk_kv
                    else [None] * n_shards)
        reports = []
        for s in range(n_shards):
            rail = kv_rails[s]
            # an earlier serve's escalation persists on the rail
            kv_codec = rail.codec if rail is not None else base_codec
            arena = KVPageArena(
                geom, profile, n_pages, seed=self.rel.seed, ecc=self.rel.ecc, codec=kv_codec,
                device=self.device, env=self.rel.environment_profile, shard=s,
            )
            if kv_voltage is not None:
                arena.set_voltage(float(kv_voltage))
            else:
                arena.set_voltage(float(self.rails[s].get("kv", self.voltage)))
            if rail is not None:
                # the controller is the source of truth for a walked rail;
                # under `uniform` it resumes where the previous shard left it
                arena.set_voltage(rail.voltage)
            reports.append(sched.serve_stream(
                self.params, self.cfg, self._paged_helpers(geom, kv_codec, draft_cfg=draft_cfg),
                arena, parts[s],
                n_lanes=n_lanes, max_len=self.max_len, scrub_interval=scrub_interval,
                max_block=max_block, kv_controller=rail,
                init_cache_fn=lambda b: lm.init_cache(self.cfg, b, self.max_len,
                                                      device=self.device),
                helpers_factory=lambda cname: self._paged_helpers(geom, cname,
                                                                  draft_cfg=draft_cfg),
                share_prefix=share_prefix, speculative=speculative,
                draft_params=draft_params, draft_cfg=draft_cfg, recorder=self.recorder,
                scrub_overlap=scrub_overlap,
            ))
            self._store.register_domain_words("kv", arena.n_words, codec=arena.codec_name,
                                              shard=s)
            self.rails[s]["kv"] = arena.voltage
        report = sched.MeshServeReport.merge(reports)
        self.stats.accumulate(report.kv_stats)
        self.rail_stats.accumulate(DomainFaultStats({"kv": report.kv_stats}))
        self.shard_stats.accumulate(ShardFaultStats([
            DomainFaultStats({"kv": st}, shard=s)
            for s, st in enumerate(report.kv_stats_by_shard)
        ]))
        self.kv_arenas = [r.arena for r in reports]
        self.kv_arena = self.kv_arenas[0]
        return report

    def _paged_helpers(self, geom: KVGeometry, codec: str = shapes.DEFAULT_CODEC,
                       draft_cfg: ModelConfig | None = None) -> serve_steps.PagedHelpers:
        key = (geom, codec, draft_cfg)
        if key not in self._paged_helper_cache:
            self._paged_helper_cache[key] = serve_steps.make_paged_helpers(
                self.cfg, geom, codec, draft_cfg=draft_cfg
            )
        return self._paged_helper_cache[key]

    # -- runtime undervolting loop ---------------------------------------------
    def autotune_voltage(self, max_rounds: int = 60):
        """Lower the rail(s) until the ECC's DED flag trips (paper §III/IV).

        Single-rail: returns (locked voltage, history). Multi-rail: each
        domain walks its own rail; returns ({domain: voltage},
        {domain: history}). Each round advances the recorder's clock by
        one."""
        assert self.rel is not None and self.controller is not None
        if self.mesh is not None:
            return self._autotune_rails_mesh(max_rounds)
        if self.rel.rails.multi_rail:
            return self._autotune_rails(max_rounds)
        for _ in range(max_rounds):
            if self.recorder:
                self.recorder.advance(1)
            v = self.controller.update(
                self._last_scrub if self.rel.mode == "inline" else self._domain_scrub(),
                divergence=self.canary_divergence(),
            )
            if self.controller.locked:
                self.set_voltage(self.controller.voltage)
                break
            self.set_voltage(v)
        return self.controller.voltage, self.controller.history

    def _autotune_rails(self, max_rounds: int):
        # Align the arena with the controller's starting schedule so the
        # first interval reflects the voltages being judged.
        self.set_rails(self.controller.voltages)
        # Only the weight arena's rails are judged here: a late-bound `kv`
        # rail is walked by the serving stream and must not hold this loop.
        arena_rails = self._store.domains
        for _ in range(max_rounds):
            if self.recorder:
                self.recorder.advance(1)
            # One canary score for every rail: the canary runs the whole model.
            volts = self.controller.update(self._last_scrub,
                                           divergence=self.canary_divergence())
            # A rail that escalated re-protects its domain before the next
            # step, so the next interval is judged under the stronger code.
            # A `kv` change stays pending for the serving loop.
            for d in arena_rails:
                cname = self.controller.rails[d].pop_codec_change()
                if cname:
                    self._store.set_domain_codec(d, cname)
            self.set_rails(volts)
            if all(self.controller.rails[d].locked for d in arena_rails):
                break
        return self.controller.voltages, self.controller.history

    def _autotune_rails_mesh(self, max_rounds: int):
        """The mesh rail search: every shard's canary is judged on its own
        counter rows. ``per_shard`` walks each chip to its own V_min;
        ``uniform`` locks one schedule at the worst chip's first DED (the
        summed counters trip on any shard's event). Returns (per-shard
        schedules, {(shard, domain): history})."""
        self.set_rails(self.controller.voltages)
        arena_rails = self._store.domains
        for _ in range(max_rounds):
            if self.recorder:
                self.recorder.advance(1)
            schedule = self.controller.update(self._last_scrub,
                                              divergence=self.canary_divergence())
            if self.controller.policy == "uniform":
                # one code per domain across the mesh (per_shard refuses ladders)
                for d in arena_rails:
                    cname = self.controller.shards[0].rails[d].pop_codec_change()
                    if cname:
                        self._store.set_domain_codec(d, cname)
            self.set_rails(schedule)
            if self.controller.locked_for(arena_rails):
                break
        return self.controller.voltages, self.controller.history

    def _domain_scrub(self) -> FaultStats:
        """A read of every array of the domain at its rail (domain mode's
        canary round)."""
        return self.domain.read_pytree("w", self._clean_params)[1]

    def _check_bits(self) -> dict:
        store = getattr(self, "_store", None)
        return store.check_bits_by_domain() if store is not None else {}

    def power_w(self) -> float:
        """Modeled accelerator power at the current rail voltage(s); on a
        mesh the fleet's, every shard its own chip."""
        ecc = bool(self.rel and self.rel.ecc)
        if self.mesh is not None:
            return self._store.n_shards * vmod.P_REST_W + vmod.mesh_bram_power(
                self.rails, self._store.shard_words_by_domain(), ecc=ecc,
                check_bits=self._check_bits(),
            )
        if self.rails is not None:
            return vmod.P_REST_W + vmod.multi_rail_bram_power(
                self.rails, self._store.words_by_domain(), ecc=ecc,
                check_bits=self._check_bits(),
            )
        factor = vmod.redundancy_factor(next(iter(self._check_bits().values()), 8))
        return vmod.P_REST_W + vmod.bram_power(self.voltage, ecc=ecc) * factor

    def power_report(self) -> dict:
        """Per-rail power breakdown + fractional BRAM saving vs nominal; on a
        mesh each shard's chip and the fleet's totals."""
        ecc = bool(self.rel and self.rel.ecc)
        bits = self._check_bits()
        if self.mesh is not None:
            words = self._store.shard_words_by_domain()
            return {
                "n_shards": self._store.n_shards,
                "policy": self.rel.rails.policy,
                "codecs": self._store.codecs_by_domain(),
                "check_bits": bits,
                "shards": [
                    {
                        "shard": s,
                        "rails": dict(self.rails[s]),
                        "bram_w": vmod.multi_rail_bram_power(
                            self.rails[s], words[s], ecc=ecc, check_bits=bits),
                        "saving_vs_nominal": vmod.multi_rail_power_saving(
                            self.rails[s], words[s], ecc=ecc, check_bits=bits),
                    }
                    for s in range(self._store.n_shards)
                ],
                "bram_w": vmod.mesh_bram_power(self.rails, words, ecc=ecc, check_bits=bits),
                "total_w": self.power_w(),
                "saving_vs_nominal": vmod.mesh_power_saving(
                    self.rails, words, ecc=ecc, check_bits=bits),
            }
        if self.rails is not None:
            words = self._store.words_by_domain()
            total = max(sum(words.values()), 1)
            return {
                "rails": dict(self.rails),
                "codecs": self._store.codecs_by_domain(),
                "check_bits": bits,
                "bram_w": vmod.multi_rail_bram_power(
                    self.rails, words, ecc=ecc, check_bits=bits
                ),
                "bram_w_by_domain": {
                    d: (words[d] / total)
                    * vmod.bram_power(v, ecc=ecc)
                    * vmod.redundancy_factor(bits.get(d, 8))
                    for d, v in self.rails.items()
                },
                "total_w": self.power_w(),
                "saving_vs_nominal": vmod.multi_rail_power_saving(
                    self.rails, words, ecc=ecc, check_bits=bits
                ),
            }
        factor = vmod.redundancy_factor(next(iter(bits.values()), 8))
        store = getattr(self, "_store", None)
        return {
            "rails": {"all": self.voltage},
            "codecs": dict(store.codecs_by_domain()) if store is not None else {},
            "bram_w": vmod.bram_power(self.voltage, ecc=ecc) * factor,
            "total_w": self.power_w(),
            "saving_vs_nominal": 1.0
            - vmod.bram_power(self.voltage, ecc=ecc) * factor / vmod.bram_power(1.0, ecc=False),
        }
