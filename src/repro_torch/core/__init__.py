"""Quake's main path: build, plan, pack, scan, rounds, insert/delete."""
from .convert import index_from_arrays, index_to_arrays
from .index import Level, QuakeConfig, QuakeIndex, SearchResult, resolve_device
from .multiquery import (BatchedSearchExecutor, BatchPlan, BatchResult,
                         RoundPlan, batch_search, get_executor,
                         per_query_search, plan_batch, plan_rounds)
from .snapshot import IndexSnapshot, SnapshotPatch

__all__ = ["BatchPlan", "BatchResult", "BatchedSearchExecutor",
           "IndexSnapshot", "Level", "QuakeConfig", "QuakeIndex",
           "RoundPlan", "SearchResult", "SnapshotPatch", "batch_search",
           "get_executor", "index_from_arrays", "index_to_arrays",
           "per_query_search", "plan_batch", "plan_rounds",
           "resolve_device"]
