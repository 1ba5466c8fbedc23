"""Reliability core: rail model, fault field, telemetry, plane arena and the
DED-canary controllers.

  * `voltage`    — calibrated fault-rate + power models (VC707/KC705-A/B)
  * `faultsim`   — per-bitcell failure-threshold field (FIP by construction)
  * `scenario`   — burst-fault shapes, environment matrix, aging drift
  * `memory`     — EccMemoryDomain: ECC-protected array storage
  * `controller` — DED-canary runtime undervolting controllers and their
                   codec escalation ladder
  * `telemetry`  — CORRECTED / DETECTED / SILENT fault accounting
  * `quantize`   — int8 + 64-bit word packing (BRAM word geometry)
  * `campaign`   — accuracy under undervolting: divergence scorers and harness
  * `sweep`      — platform x voltage, rail-schedule and codec-scheme sweeps
"""

from repro_torch.core import (
    campaign, controller, faultsim, memory, quantize, scenario, sweep, telemetry, voltage,
)
from repro_torch.core.campaign import CampaignSpec, DivergenceReport, run_campaign
from repro_torch.core.controller import (
    EscalationPolicy,
    MultiRailController,
    UndervoltController,
)
from repro_torch.core.faultsim import FaultField, FlipMasks
from repro_torch.core.kvpages import SharedPageDEDError
from repro_torch.core.memory import EccMemoryDomain
from repro_torch.core.scenario import ENVIRONMENTS, BurstProfile, EnvironmentProfile
from repro_torch.core.telemetry import DomainFaultStats, FaultStats
from repro_torch.core.voltage import PLATFORMS, PlatformProfile

__all__ = [
    "campaign", "controller", "faultsim", "memory", "quantize", "scenario", "sweep",
    "telemetry", "voltage", "CampaignSpec", "DivergenceReport", "run_campaign",
    "EscalationPolicy", "MultiRailController", "UndervoltController", "FaultField",
    "FlipMasks", "SharedPageDEDError",
    "EccMemoryDomain", "DomainFaultStats", "FaultStats", "PLATFORMS", "PlatformProfile",
    "ENVIRONMENTS", "BurstProfile", "EnvironmentProfile",
]
