from .agg_engine import (
    AggregationEngine,
    AggStats,
    RavelPlan,
    StructureMismatchError,
    clear_plan_cache,
    plan_cache_size,
    plan_for,
    set_plan_cache_limit,
)
from .aggregation import aggregate_metrics, fedavg
from .async_server import (
    ArrivalSchedule,
    AsyncRoundEngine,
    ClientArrival,
    FoldEvent,
    FoldReport,
    InstantSchedule,
)
from .client import ClientResult, EvalResult, FLClient
from .messages import RoundMessageLog, measure_messages, serialize_metrics
from .server import FLRunResult, FLServer, RoundRecord

__all__ = [
    "AggStats",
    "AggregationEngine",
    "ArrivalSchedule",
    "AsyncRoundEngine",
    "ClientArrival",
    "ClientResult",
    "EvalResult",
    "FLClient",
    "FLRunResult",
    "FLServer",
    "FoldEvent",
    "FoldReport",
    "InstantSchedule",
    "RavelPlan",
    "RoundMessageLog",
    "RoundRecord",
    "StructureMismatchError",
    "aggregate_metrics",
    "clear_plan_cache",
    "fedavg",
    "measure_messages",
    "plan_cache_size",
    "plan_for",
    "serialize_metrics",
    "set_plan_cache_limit",
]
