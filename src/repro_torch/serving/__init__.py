"""The serving API: the engine and its grouped reliability configuration,
the request/report types, the paged decode-block helpers with their
contract (``DecodeBlockHelpers``, ``HelpersFactory``) and the flight
recorder. Submodules stay importable directly::

    from repro_torch.serving import ServingEngine, ReliabilityConfig, TraceRecorder

``engine`` imports ``scheduler`` and ``steps``, so those load first."""

from repro_torch.obs import MetricsRegistry, TraceRecorder
from repro_torch.serving.scheduler import (
    ContinuousBatchingScheduler,
    Request,
    RequestState,
    ServeReport,
    ServeRequest,
    normalize_requests,
    serve_stream,
)
from repro_torch.serving.steps import (
    DecodeBlockHelpers,
    HelpersFactory,
    PagedHelpers,
    make_paged_helpers,
    make_prefill_step,
    make_serve_step,
)
from repro_torch.serving.engine import (
    CanaryConfig,
    FaultModelConfig,
    ProtectionConfig,
    RailsConfig,
    ReliabilityConfig,
    ReliabilityConfigError,
    ServingEngine,
)

__all__ = [
    "CanaryConfig",
    "ContinuousBatchingScheduler",
    "DecodeBlockHelpers",
    "FaultModelConfig",
    "HelpersFactory",
    "MetricsRegistry",
    "PagedHelpers",
    "ProtectionConfig",
    "RailsConfig",
    "ReliabilityConfig",
    "ReliabilityConfigError",
    "Request",
    "RequestState",
    "ServeReport",
    "ServeRequest",
    "ServingEngine",
    "TraceRecorder",
    "make_paged_helpers",
    "make_prefill_step",
    "make_serve_step",
    "normalize_requests",
    "serve_stream",
]
