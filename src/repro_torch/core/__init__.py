"""Multi-FedLS core: the paper's resource-management contribution.

The port's own copy of ``repro/core``: every module below is a copy of
the reference's, with the same names exported, and the builder's serve
targets reach this package's ``federated`` servers.

Module map (paper Fig. 1, re-architected around a typed control plane):

  environment & application models (§3)
    cloud_model / application_model : providers, regions, VM types, FL app

  the four framework modules, each behind a `typing.Protocol` surface
  (control_plane.{PreSchedulerAPI, MapperAPI, FaultToleranceAPI,
  SchedulerAPI}) so policies plug in without forking the engine:
    pre_scheduling                  : §4.1 slowdown metrics
    cost_model + initial_mapping    : §4.2 MILP placement (+ round_plan,
                                      the unified per-round accounting)
    fault_tolerance                 : §4.3 checkpoint & recovery plans
    dynamic_scheduler               : §4.4 Algorithms 1-3

  orchestration
    events                          : typed event vocabulary + EventBus —
                                      the trace language shared by the
                                      simulator and the live async engine
    control_plane                   : ControlPlane (binds the modules to
                                      the bus: §4.3 recovery, §4.4
                                      straggler escalation, checkpoints)
                                      + the fluent `Experiment` builder
    revocation + simulator          : §5 experiment engine — one driver
                                      of the control plane; the others
                                      live in repro_torch.federated: the
                                      in-process async engine and the
                                      wall-clock socket transport
                                      (federated.transport, built via
                                      Experiment.transport().serve())

Prefer `Experiment.on(env).app(app)...simulate()` over constructing the
deprecated `SimulationConfig` shim directly; see docs/control_plane.md.
"""
from .application_model import (
    ClientSpec,
    FLApplication,
    MessageSizes,
    femnist_application,
    shakespeare_application,
    til_application,
    til_application_aws,
)
from .autopilot import (
    AutopilotSpec,
    BudgetTracker,
    BudgetedMapper,
    CostAwareScheduler,
    DeadlineController,
    PriceTicker,
)
from .cloud_model import (
    CloudEnvironment,
    PriceFeed,
    PricePoint,
    Provider,
    Region,
    SpotPriceTrace,
    SyntheticSpotFeed,
    TracePriceFeed,
    VMType,
    aws_gcp_environment,
    cloudlab_environment,
)
from .control_plane import (
    ControlPlane,
    Experiment,
    FaultToleranceAPI,
    MapperAPI,
    PreSchedulerAPI,
    RecoveryOutcome,
    SchedulerAPI,
    StragglerTracker,
)
from .cost_model import (
    SERVER,
    Assignment,
    CostModel,
    DeadlineRoundPlan,
    Placement,
    PlacementEvaluation,
    RoundPlan,
)
from .dynamic_scheduler import BudgetSignal, DynamicScheduler, ReplacementDecision
from .events import (
    BudgetExceeded,
    CheckpointSaved,
    CostAccrued,
    DeadlineAdjusted,
    DeadlineExpired,
    Event,
    EventBus,
    NullBus,
    PriceUpdated,
    RecoveryCompleted,
    RevocationOccurred,
    RoundClosed,
    RoundDispatched,
    StragglerEscalated,
    UpdateArrived,
    UpdateFolded,
    VMReplaced,
)
from .fault_tolerance import (
    CheckpointPolicy,
    CheckpointRecord,
    FaultToleranceModule,
    RecoveryPlan,
    RiskAwareCheckpointPolicy,
)
from .initial_mapping import InfeasibleMappingError, InitialMapping, MappingSolution
from .pre_scheduling import (
    CallableProbe,
    ExecutionProbe,
    PreScheduling,
    PreSchedulingResult,
    ProbeResult,
    TableProbe,
    expected_comm_time,
    expected_exec_time,
)
from .revocation import RevocationModel, RevocationSampler
from .simulator import (
    EscalationEvent,
    MultiCloudSimulator,
    RevocationEvent,
    SimulationConfig,
    SimulationResult,
)

__all__ = [
    "SERVER",
    "Assignment",
    "AutopilotSpec",
    "BudgetExceeded",
    "BudgetSignal",
    "BudgetTracker",
    "BudgetedMapper",
    "CallableProbe",
    "CheckpointPolicy",
    "CheckpointRecord",
    "CheckpointSaved",
    "ClientSpec",
    "CloudEnvironment",
    "ControlPlane",
    "CostAccrued",
    "CostAwareScheduler",
    "CostModel",
    "DeadlineAdjusted",
    "DeadlineController",
    "DeadlineExpired",
    "DeadlineRoundPlan",
    "DynamicScheduler",
    "EscalationEvent",
    "Event",
    "EventBus",
    "ExecutionProbe",
    "Experiment",
    "FLApplication",
    "FaultToleranceAPI",
    "FaultToleranceModule",
    "InfeasibleMappingError",
    "InitialMapping",
    "MapperAPI",
    "MappingSolution",
    "MessageSizes",
    "MultiCloudSimulator",
    "NullBus",
    "Placement",
    "PlacementEvaluation",
    "PriceFeed",
    "PricePoint",
    "PriceTicker",
    "PriceUpdated",
    "PreScheduling",
    "PreSchedulerAPI",
    "PreSchedulingResult",
    "ProbeResult",
    "Provider",
    "RecoveryCompleted",
    "RecoveryOutcome",
    "RecoveryPlan",
    "Region",
    "ReplacementDecision",
    "RevocationEvent",
    "RevocationModel",
    "RevocationOccurred",
    "RevocationSampler",
    "RiskAwareCheckpointPolicy",
    "RoundClosed",
    "RoundDispatched",
    "RoundPlan",
    "SchedulerAPI",
    "SimulationConfig",
    "SimulationResult",
    "SpotPriceTrace",
    "StragglerEscalated",
    "StragglerTracker",
    "SyntheticSpotFeed",
    "TableProbe",
    "TracePriceFeed",
    "UpdateArrived",
    "UpdateFolded",
    "VMReplaced",
    "VMType",
    "aws_gcp_environment",
    "cloudlab_environment",
    "expected_comm_time",
    "expected_exec_time",
    "femnist_application",
    "shakespeare_application",
    "til_application",
    "til_application_aws",
]
