"""Quake's main path: build, plan, pack, scan, rounds, insert/delete, the
int8 storage path, and cost-model maintenance."""
from .convert import index_from_arrays, index_to_arrays
from .cost_model import (LatencyModel, PartitionStats, fit_latency_model,
                         profile)
from .index import Level, QuakeConfig, QuakeIndex, SearchResult, resolve_device
from .maintenance import (Maintainer, MaintenancePolicy, MaintenanceReport,
                          checkpoint_index, restore_index)
from .multiquery import (BatchedSearchExecutor, BatchPlan, BatchResult,
                         RoundPlan, batch_search, get_executor,
                         per_query_search, plan_batch, plan_rounds)
from .snapshot import IndexSnapshot, SnapshotPatch

__all__ = ["BatchPlan", "BatchResult", "BatchedSearchExecutor",
           "IndexSnapshot", "LatencyModel", "Level", "Maintainer",
           "MaintenancePolicy", "MaintenanceReport", "PartitionStats",
           "QuakeConfig", "QuakeIndex", "RoundPlan", "SearchResult",
           "SnapshotPatch", "batch_search", "checkpoint_index",
           "fit_latency_model", "get_executor", "index_from_arrays",
           "index_to_arrays", "per_query_search", "plan_batch",
           "plan_rounds", "profile", "resolve_device", "restore_index"]
