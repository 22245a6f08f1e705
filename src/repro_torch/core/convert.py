"""Index state as plain numpy arrays, and a port index built from them.

``index_from_arrays`` builds a ``QuakeIndex`` from a flat dict of numpy
arrays and scalars, so two implementations can be compared on an
identical structure (k-means in two frameworks drifts apart in the last
float bits and would hide search differences).  The schema:

  "dim", "max_norm_sq", "num_levels"            scalars
  "config.<field>"                              every QuakeConfig field
  "level{l}.centroids"                          (P_l, d) float32
  "level0.sizes"                                (P_0,) partition sizes
  "level0.vectors" / ".ids" / ".sqnorms"        rows of all partitions,
                                                concatenated in order
  "level{l}.child_sizes" / ".children"          l > 0, concatenated
  "level{l}.parent"                             levels below the top
  "level{l}.hits" / ".window"                   optional: the access
                                                statistics (PartitionStats)
  "maintenance_log"                             optional: list of dicts
  "beta_table"                                  optional: the APS beta
                                                grid (default: computed)
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from .cost_model import PartitionStats
from .index import Level, QuakeConfig, QuakeIndex


def _split(flat: np.ndarray, sizes: np.ndarray):
    bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return [flat[bounds[j]:bounds[j + 1]] for j in range(len(sizes))]


def index_to_arrays(index: QuakeIndex) -> Dict[str, object]:
    """The index's state in the schema above, as copies (maintenance
    updates centroids and statistics in place)."""
    state: Dict[str, object] = {
        "dim": index.dim, "max_norm_sq": float(index._max_norm_sq),
        "num_levels": len(index.levels),
        "beta_table": np.asarray(index._beta_table, dtype=np.float32)}
    for f in dataclasses.fields(QuakeConfig):
        state[f"config.{f.name}"] = getattr(index.config, f.name)
    for l, level in enumerate(index.levels):
        state[f"level{l}.centroids"] = np.array(level.centroids,
                                                dtype=np.float32)
        if l == 0:
            state["level0.sizes"] = level.sizes().astype(np.int64)
            state["level0.vectors"] = np.concatenate(
                level.vectors).astype(np.float32)
            state["level0.ids"] = np.concatenate(level.ids).astype(np.int64)
            state["level0.sqnorms"] = np.concatenate(
                level.sqnorms).astype(np.float32)
        else:
            state[f"level{l}.child_sizes"] = level.sizes().astype(np.int64)
            state[f"level{l}.children"] = np.concatenate(
                level.children).astype(np.int64)
        if level.parent is not None:
            state[f"level{l}.parent"] = np.asarray(level.parent,
                                                   dtype=np.int64)
        state[f"level{l}.hits"] = np.array(level.stats.hits,
                                           dtype=np.float64)
        state[f"level{l}.window"] = int(level.stats.window)
    state["maintenance_log"] = list(index.maintenance_log)
    return state


def index_from_arrays(state: Dict[str, object], device="cuda"
                      ) -> QuakeIndex:
    """A port ``QuakeIndex`` on ``device`` holding exactly ``state``, in
    arrays of its own: maintenance updates centroids and parent maps in
    place, which must not reach the index ``state`` came from."""
    cfg_fields = {f.name for f in dataclasses.fields(QuakeConfig)}
    cfg = QuakeConfig(**{
        key.split(".", 1)[1]: (v.item() if isinstance(v, np.generic) else v)
        for key, v in state.items()
        if key.startswith("config.") and key.split(".", 1)[1] in cfg_fields})
    idx = QuakeIndex(int(state["dim"]), cfg, device=device)
    idx._max_norm_sq = float(state["max_norm_sq"])
    if state.get("beta_table") is not None:
        idx._beta_table = np.asarray(state["beta_table"], dtype=np.float32)
    for l in range(int(state["num_levels"])):
        cents = np.array(state[f"level{l}.centroids"], dtype=np.float32)
        stats = PartitionStats(
            hits=np.array(state.get(f"level{l}.hits", np.zeros(0)),
                          dtype=np.float64),
            window=int(state.get(f"level{l}.window", 0)))
        if l == 0:
            sizes = np.asarray(state["level0.sizes"], dtype=np.int64)
            vectors = [np.ascontiguousarray(v) for v in _split(
                np.asarray(state["level0.vectors"], dtype=np.float32),
                sizes)]
            ids = _split(np.asarray(state["level0.ids"], dtype=np.int64),
                         sizes)
            sqn = _split(np.asarray(state["level0.sqnorms"],
                                    dtype=np.float32), sizes)
            level = Level(centroids=cents, vectors=vectors, ids=ids,
                          sqnorms=sqn, stats=stats)
        else:
            level = Level(centroids=cents, children=_split(
                np.asarray(state[f"level{l}.children"], dtype=np.int64),
                np.asarray(state[f"level{l}.child_sizes"], dtype=np.int64)),
                stats=stats)
        parent = state.get(f"level{l}.parent")
        if parent is not None:
            level.parent = np.array(parent, dtype=np.int64)
        idx.levels.append(level)
    for j, ext in enumerate(idx.levels[0].ids):
        idx.id_map.update(dict.fromkeys(ext.tolist(), j))
    idx._aug_extra = [None] * len(idx.levels)
    idx.maintenance_log = list(state.get("maintenance_log", []))
    return idx
