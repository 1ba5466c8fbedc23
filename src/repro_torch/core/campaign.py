"""Accuracy under undervolting: divergence scorers and the campaign harness.

Everywhere else the paper's claim ("negligible NN accuracy loss") is read
through proxies, the DED counters. This module measures what a user of a
served LM sees: how far the fault-injected undervolted run's output strays
from the clean nominal run, per codec, per voltage and per environment.

Scorers (each exactly zero for clean against clean):

  * greedy matched-prefix length: per prompt, the greedy tokens that match
    the clean rollout before the first mismatch; ``token_divergence`` turns
    a batch into ``1 - mean(match_len) / n`` in [0, 1];
  * logit KL: mean KL(clean || faulty) in nats over teacher-forced,
    position-aligned logits (``models.lm.sequence_logits`` of the same
    tokens through both parameter sets);
  * perplexity: each parameter set's perplexity of the clean continuation.

The scorers are NumPy: host arithmetic on a few small arrays.

``run_campaign`` drives a single-rail inline ``ServingEngine`` per
(environment, codec): the clean rollout at nominal (the guardband is
fault-free, so nominal is clean), then every grid voltage, re-scored. The
prompts are synthetic and fixed by the seed; the weights are random, so the
campaign measures the output's stability under faults, not task accuracy.
Scores are taken against the engine's own quantized clean output, so
quantization cancels and a nonzero score is injected damage alone.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core import scenario, sweep
from repro_torch.core import voltage as vmod

# Bumped whenever a scorer's definition changes, so rows are compared only
# within one scorer generation.
SCORER_VERSION = 1

# Canary prompt length (ServingEngine.canary_divergence): a canary round is
# one prefill and a dozen decode steps.
CANARY_PROMPT_LEN = 8


# ---------------------------------------------------------------------------
# Scorers
# ---------------------------------------------------------------------------
def greedy_match_len(ref: np.ndarray, test: np.ndarray) -> np.ndarray:
    """Per-row matched-prefix length of two (B, T) token grids: row i scores
    t iff ``ref[i, :t] == test[i, :t]`` and t == T or ``ref[i, t] !=
    test[i, t]``."""
    ref = np.asarray(ref)
    test = np.asarray(test)
    assert ref.shape == test.shape and ref.ndim == 2, (ref.shape, test.shape)
    neq = ref != test
    return np.where(neq.any(axis=1), neq.argmax(axis=1), ref.shape[1]).astype(np.int64)


def token_divergence(ref: np.ndarray, test: np.ndarray) -> float:
    """``1 - mean(matched prefix fraction)`` in [0, 1]; exactly 0.0 iff every
    row of ``test`` equals ``ref``."""
    ref = np.asarray(ref)
    n = ref.shape[1]
    if n == 0:
        return 0.0
    return float(1.0 - greedy_match_len(ref, test).mean() / n)


def label_divergence(ref: np.ndarray, test: np.ndarray) -> float:
    """Fraction of predictions that differ from the clean run's (the
    classifier form of ``token_divergence``, for the Fig. 3 MLP). Exactly
    0.0 iff every prediction matches."""
    ref = np.asarray(ref)
    test = np.asarray(test)
    assert ref.shape == test.shape, (ref.shape, test.shape)
    if ref.size == 0:
        return 0.0
    return float((ref != test).mean())


def _log_softmax(logits: np.ndarray) -> np.ndarray:
    x = np.asarray(logits, np.float64)
    x = x - x.max(axis=-1, keepdims=True)
    return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))


def logit_kl(ref_logits: np.ndarray, test_logits: np.ndarray) -> float:
    """Mean KL(ref || test) in nats over every (batch, position) cell of
    position-aligned (..., V) logits; identical logits score exactly 0.0."""
    ref_logits = np.asarray(ref_logits)
    assert ref_logits.shape == np.asarray(test_logits).shape
    logp = _log_softmax(ref_logits)
    logq = _log_softmax(test_logits)
    return float((np.exp(logp) * (logp - logq)).sum(axis=-1).mean())


def token_nll(logits: np.ndarray, tokens: np.ndarray) -> float:
    """Mean negative log-likelihood (nats a token) of ``tokens`` (B, T) under
    position-aligned ``logits`` (B, T, V)."""
    logits = np.asarray(logits)
    tokens = np.asarray(tokens)
    assert logits.shape[:2] == tokens.shape, (logits.shape, tokens.shape)
    gold = np.take_along_axis(_log_softmax(logits), tokens[..., None], axis=-1)[..., 0]
    return float(-gold.mean())


def perplexity(logits: np.ndarray, tokens: np.ndarray) -> float:
    return float(np.exp(token_nll(logits, tokens)))


@dataclasses.dataclass(frozen=True)
class DivergenceReport:
    """One (voltage, codec) point's divergence from the clean nominal run."""

    n_prompts: int
    n_tokens: int
    match_len: float  # mean greedy matched-prefix length (tokens)
    match_frac: float  # match_len / n_tokens
    divergence: float  # 1 - match_frac (the curve's y axis and the SLO's unit)
    kl: float  # mean KL(clean || faulty), nats (teacher-forced)
    ppl_clean: float  # the clean params' perplexity of the clean continuation
    ppl_faulty: float  # the faulty params' perplexity of the same continuation
    ppl_delta: float  # ppl_faulty - ppl_clean (0 when bit-identical)
    scorer_version: int = SCORER_VERSION


def score(
    ref_tokens: np.ndarray,
    test_tokens: np.ndarray,
    ref_logits: np.ndarray | None = None,
    test_logits: np.ndarray | None = None,
    eval_tokens: np.ndarray | None = None,
) -> DivergenceReport:
    """Every scorer over one clean/faulty rollout pair: (B, T) greedy
    continuations, and optionally (B, S, V) teacher-forced logits over
    ``eval_tokens`` (B, S), the clean continuation both parameter sets are
    forced through (without them KL and perplexity report 0.0)."""
    ref_tokens = np.asarray(ref_tokens)
    n = ref_tokens.shape[1]
    match = greedy_match_len(ref_tokens, test_tokens)
    kl = ppl_c = ppl_f = 0.0
    if ref_logits is not None:
        assert test_logits is not None and eval_tokens is not None
        kl = logit_kl(ref_logits, test_logits)
        ppl_c = perplexity(ref_logits, eval_tokens)
        ppl_f = perplexity(test_logits, eval_tokens)
    return DivergenceReport(
        n_prompts=int(ref_tokens.shape[0]),
        n_tokens=int(n),
        match_len=float(match.mean()),
        match_frac=float(match.mean() / max(n, 1)),
        divergence=token_divergence(ref_tokens, test_tokens),
        kl=kl,
        ppl_clean=ppl_c,
        ppl_faulty=ppl_f,
        ppl_delta=ppl_f - ppl_c,
    )


# ---------------------------------------------------------------------------
# Eval set and model configs
# ---------------------------------------------------------------------------
def eval_prompts(vocab: int, n_prompts: int, prompt_len: int, seed: int = 0) -> np.ndarray:
    """The fixed synthetic eval set: (n_prompts, prompt_len) int32 in [0,
    vocab), deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(n_prompts, prompt_len), dtype=np.int64).astype(np.int32)


def campaign_model(name: str):
    """A campaign model name as a ModelConfig: ``tiny`` is qwen2-7b's layer
    recipe at smoke size, ``<arch>-smoke`` any registered arch shrunk, a
    bare arch name its published config."""
    from repro_torch import configs

    if name == "tiny":
        return dataclasses.replace(configs.get_smoke_config("qwen2-7b"), name="tiny")
    if name.endswith("-smoke"):
        return configs.get_smoke_config(name[: -len("-smoke")])
    return configs.get_config(name)


def campaign_params(cfg, seed: int, device):
    """The campaign's random weights: ``lm.init_params`` from ``seed``."""
    from repro_torch.models import lm

    return lm.init_params(cfg, seed=seed, device=device)


# ---------------------------------------------------------------------------
# Campaign harness
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """One accuracy campaign: model x codecs x voltages x environments."""

    model: str = "tiny"
    platform: str = "vc707"
    codecs: tuple = ("parity65", "secded72", "ileave88")
    voltages: tuple | None = None  # None: sweep.campaign_voltage_grid
    environments: tuple = (None,)  # scenario names, profiles or None
    n_prompts: int = 4
    prompt_len: int = 8
    n_tokens: int = 24
    seed: int = 0
    max_len: int = 64
    # words of the sweep proxy joined onto each row (0: none): what the DED
    # counters say at the same grid point
    proxy_words: int = 1 << 16

    def voltage_grid(self) -> tuple:
        if self.voltages is not None:
            return tuple(float(v) for v in self.voltages)
        return sweep.campaign_voltage_grid(vmod.PLATFORMS[self.platform])


def run_campaign(spec: CampaignSpec, recorder=None, device=None) -> list[dict]:
    """Run the campaign: one row dict per (environment, codec, voltage).

    Per (environment, codec) a single-rail inline ServingEngine is built at
    nominal; its rollout and teacher-forced logits are the clean reference,
    and each grid voltage re-injects faults (``set_voltage``) and re-scores.
    A row joins the DivergenceReport, the engine's scrub counters, the
    sweep proxy at the same point and the modelled BRAM power saving. A
    ``recorder`` (obs.TraceRecorder) gets one ``campaign_point`` event per
    row, its clock advanced once per point. ``device`` None is the card.
    """
    import torch

    from repro_torch.kernels.backend import resolve_device
    from repro_torch.models import lm
    from repro_torch.serving.engine import (
        FaultModelConfig, ProtectionConfig, ReliabilityConfig, ServingEngine,
    )

    dev = resolve_device(device)
    cfg = campaign_model(spec.model)
    profile = vmod.PLATFORMS[spec.platform]
    voltages = spec.voltage_grid()
    prompts = eval_prompts(cfg.vocab, spec.n_prompts, spec.prompt_len, seed=spec.seed)
    params = campaign_params(cfg, spec.seed, dev)

    rows: list[dict] = []
    for env in spec.environments:
        envp = scenario.resolve(env)
        env_name = envp.name if envp is not None else None
        for codec in spec.codecs:
            proxy: dict = {}
            if spec.proxy_words:
                grid = [(profile, float(v)) for v in voltages]
                for r in sweep.sweep_codec_schemes([codec], grid, spec.proxy_words,
                                                   seed=spec.seed, env=envp, device=dev):
                    proxy[round(r["voltage"], 4)] = r
            rel = ReliabilityConfig(
                platform=spec.platform, mode="inline",
                protection=ProtectionConfig(codecs=codec),
                fault_model=FaultModelConfig(environment=envp), seed=spec.seed,
            )
            eng = ServingEngine(cfg, params, rel=rel, max_len=spec.max_len, device=dev)
            # nominal injects no fault: this rollout is the clean reference
            ref_tokens = eng.generate(prompts, spec.n_tokens)
            eval_tokens = np.concatenate([prompts, ref_tokens], axis=1)
            full = torch.as_tensor(eval_tokens, dtype=torch.int64, device=dev)
            # teacher-forced logits predicting positions prompt_len .. end
            sl = slice(spec.prompt_len - 1, -1)
            logits_of = lambda p: lm.sequence_logits(p, full, cfg)[:, sl].cpu().numpy()
            ref_logits = logits_of(eng.params)
            cont = eval_tokens[:, spec.prompt_len:]
            for v in voltages:
                t0 = time.perf_counter()
                eng.set_voltage(float(v))
                test_tokens = eng.generate(prompts, spec.n_tokens)
                test_logits = logits_of(eng.params)
                us = (time.perf_counter() - t0) * 1e6
                rep = score(ref_tokens, test_tokens, ref_logits, test_logits, cont)
                row = {
                    "model": spec.model,
                    "arch": cfg.name,
                    "platform": profile.name,
                    "codec": codec,
                    "environment": env_name,
                    "voltage": float(v),
                    "nominal": float(v) >= profile.v_min,
                    **dataclasses.asdict(rep),
                    **eng._last_scrub.to_dict(),
                    "bram_saving_vs_nominal": vmod.power_saving(profile.v_nom, float(v),
                                                                ecc=True),
                    "seed": spec.seed,
                    "us": us,
                }
                if recorder:
                    recorder.advance(1)
                    recorder.emit("campaign_point", voltage=float(v), codec=codec,
                                  divergence=float(rep.divergence))
                pr = proxy.get(round(float(v), 4))
                if pr is not None:
                    row.update(
                        proxy_words=pr["words"],
                        proxy_faulty_words=pr["faulty_words"],
                        proxy_corrected=pr["corrected"],
                        proxy_detected=pr["detected"],
                        proxy_silent=pr["silent"],
                    )
                rows.append(row)
            del eng
    return rows
