"""Finds a cell's configuration, traffic mix, metrics and readers by name."""
from __future__ import annotations

import copy
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

QBENCH = Path(__file__).resolve().parent
ROOT = QBENCH.parent
BENCHMARK = ROOT / "BENCHMARK.json"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    config_name: str = ""
    limits: Dict[str, float] = field(default_factory=dict)


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def _applies(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = copy.deepcopy(base)
    for key, val in (over or {}).items():
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key] = _merge(out[key], val)
        else:
            out[key] = val
    return out


def load_cell(name: str, bench: Optional[dict] = None,
              overrides: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``.  ``overrides`` (tests,
    rehearsals and sweeps) replaces keys of the configuration (``config``), the
    mix (``traffic``) or the correctness limits (``limits``)."""
    bench = bench or load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(sorted(cells))})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((QBENCH / "traffic"
                          / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, names)]
    lim_dir = QBENCH / "limits"
    lim_file = lim_dir / f"{name}.json"
    limits = json.loads((lim_file if lim_file.exists()
                         else lim_dir / "default.json").read_text())
    overrides = overrides or {}
    return Cell(name=name, chips=int(w["chips"]),
                config=_merge(config, overrides.get("config")),
                traffic=_merge(traffic, overrides.get("traffic")),
                end_to_end=e2e, per_layer=per_layer,
                config_name=w["config"],
                limits=_merge(limits, overrides.get("limits")))


def load_module(path: Path, tag: str):
    """Import one reader by its file path (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        f"qbench_{tag}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    return load_module(QBENCH / "metrics" / f"{name}.py", "metric")


def roofline_module(kernel: str):
    return load_module(QBENCH / "roofline" / f"{kernel}.py", "roofline")


def roofline_kernels(per_layer: List[dict]) -> List[str]:
    """The kernels a cell's traced run records: those whose share of its
    roofline, ``<kernel>_roofline[.<suffix>]``, is one of the cell's
    per-layer metrics (each has ``roofline/<kernel>.py``)."""
    tail = "_roofline"
    heads = (m["name"].split(".")[0] for m in per_layer)
    return sorted({h[:-len(tail)] for h in heads if h.endswith(tail)})
