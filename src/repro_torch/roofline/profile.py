"""Op-level attribution of a counted cell: which collectives and which
memory ops dominate it (the reference's ``roofline/hlo_profile.py``).

The reference reads XLA's optimized HLO; the port reads the two tables
that ``count.count_call`` keeps while it runs the program on ``meta``:
``op_table`` (every op's unfused bytes by op class) and
``collective_table`` (the mesh's records, identical ones counted as
trips).  So the rows add up to the count's own totals: the collectives'
wire bytes to ``collectives["wire_bytes"]``, the memory ops' bytes to
the op part of ``bytes_accessed`` (the kernels' own bytes are
``count["kernels"]``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple


def top_collectives(count: Dict, n: int = 12) -> List[Dict]:
    """Collectives ranked by wire bytes: rows of ``kind``, ``shape`` (the
    result's), ``trips`` (identical records), ``wire_gb_total``, ``comp``
    (the forward or backward pass) and ``axes``."""
    rows = [{"kind": r["kind"], "shape": r["shape"], "trips": r["trips"],
             "wire_gb_total": r["wire_bytes"] / 1e9, "comp": r["comp"],
             "axes": r["axes"]}
            for r in count.get("collective_table", {}).values()]
    rows.sort(key=lambda r: -r["wire_gb_total"])
    return rows[:n]


def top_memory_ops(count: Dict, n: int = 12
                   ) -> List[Tuple[str, float, str]]:
    """Op classes ranked by unfused bytes: (op class, GB, example result
    shape)."""
    rows = sorted(count["op_table"].items(), key=lambda kv: -kv[1]["bytes"])
    return [(k, v["bytes"] / 1e9, v["example"]) for k, v in rows[:n]]


def print_profile(count: Dict, n: int = 10) -> None:
    """Both tables as ``benchmarks/perf_lm.py --profile`` prints them."""
    print("  -- top collectives (trip-weighted) --")
    for row in top_collectives(count, n):
        print(f"    {row['kind']:<20} {row['shape']:<36} "
              f"x{row['trips']:<5.0f} {row['wire_gb_total']:9.3f} GB"
              f"   [{row['comp']}]")
    print("  -- top memory opcode classes --")
    for op, gb, ex in top_memory_ops(count, n):
        print(f"    {op:<24} {gb:10.3f} GB   e.g. {ex}")
