"""Control-plane pieces the port's round paths publish on and consult:
the event bus (``events``), the §5.6 revocation model (``revocation``),
the §4.4 straggler policy (``control_plane``), and the environment,
application and cost models with the §4.4 Dynamic Scheduler
(``cloud_model``, ``application_model``, ``cost_model``,
``dynamic_scheduler``), which the live transport's VM replacement and
its measured message sizes (Eq. 6) use."""
from .application_model import (
    ClientSpec,
    FLApplication,
    MessageSizes,
    femnist_application,
    shakespeare_application,
    til_application,
    til_application_aws,
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

__all__ = [
    "SERVER",
    "Assignment",
    "BudgetSignal",
    "ClientSpec",
    "CloudEnvironment",
    "CostModel",
    "DeadlineRoundPlan",
    "DynamicScheduler",
    "FLApplication",
    "MessageSizes",
    "Placement",
    "PlacementEvaluation",
    "PriceFeed",
    "PricePoint",
    "Provider",
    "Region",
    "ReplacementDecision",
    "RoundPlan",
    "SpotPriceTrace",
    "SyntheticSpotFeed",
    "TracePriceFeed",
    "VMType",
    "aws_gcp_environment",
    "cloudlab_environment",
    "femnist_application",
    "shakespeare_application",
    "til_application",
    "til_application_aws",
]
