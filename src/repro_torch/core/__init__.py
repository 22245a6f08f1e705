"""Quake's main path: build, plan, pack, scan, rounds, insert/delete, the
int8 storage path, cost-model maintenance, durability (WAL and
checkpoints), the online serving runtime and the mesh-sharded engine."""
from .convert import index_from_arrays, index_to_arrays
from .distributed import EngineConfig, ShardedQuakeEngine
from .cost_model import (LatencyModel, PartitionStats, fit_latency_model,
                         profile)
from .index import Level, QuakeConfig, QuakeIndex, SearchResult, resolve_device
from .maintenance import (Maintainer, MaintenancePolicy, MaintenanceReport,
                          checkpoint_index, restore_index)
from .multiquery import (BatchedSearchExecutor, BatchPlan, BatchResult,
                         RoundPlan, batch_search, get_executor,
                         per_query_search, plan_batch, plan_rounds)
from .serving import (STATUS_FAILED, STATUS_OK, STATUS_PARTIAL, STATUS_SHED,
                      TERMINAL_STATUSES, MaintenanceScheduler,
                      MaintenanceTriggers, QueryResult, ResultCache,
                      ServingConfig, ServingRuntime)
from .snapshot import IndexSnapshot, SnapshotPatch

__all__ = ["BatchPlan", "BatchResult", "BatchedSearchExecutor",
           "EngineConfig", "IndexSnapshot", "LatencyModel", "Level", "Maintainer",
           "MaintenancePolicy", "MaintenanceReport",
           "MaintenanceScheduler", "MaintenanceTriggers", "PartitionStats",
           "QuakeConfig", "QuakeIndex", "QueryResult", "ResultCache",
           "RoundPlan", "STATUS_FAILED", "STATUS_OK", "STATUS_PARTIAL",
           "STATUS_SHED", "SearchResult", "ServingConfig",
           "ServingRuntime", "ShardedQuakeEngine", "SnapshotPatch", "TERMINAL_STATUSES",
           "batch_search", "checkpoint_index",
           "fit_latency_model", "get_executor", "index_from_arrays",
           "index_to_arrays", "per_query_search", "plan_batch",
           "plan_rounds", "profile", "resolve_device", "restore_index"]
