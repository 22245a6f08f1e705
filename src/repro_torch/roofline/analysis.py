"""Three-term roofline of one rank's counted program (the reference's
``roofline/analysis.py`` for a count made on ``meta`` instead of XLA's
compiled module):

    compute term    = sum over types of FLOPs / peak FLOP/s of the type
    memory term     = bytes per device      / HBM bandwidth
    collective term = wire bytes per device / link bandwidth

The FLOPs are the count's, split by the dtype of each op's first input
(bf16 and f16 at the tensor cores' dense peak, f32 at the CUDA cores'
rate: the port leaves TF32 off, int8 at the int8 peak), and the kernels'
own, each at the rate of its type; the bytes are each op's inputs and
outputs summed, unfused (``bytes_accessed``, an upper bound: XLA's
figure counted fused kernels' traffic once, and the card's caches and
fused kernels move less), so a "memory" dominant term can overstate the
memory side; the wire bytes
are the mesh's record of its collectives, by the ring formulas of the
reference's ``parse_collectives``.  ``model_flops`` is the reference's
analytic useful work per cell, unchanged.

The reference parses XLA HLO text (``hlo_cost.py``, ``hlo_profile.py``)
for these numbers; the port has no HLO, so those modules have no
counterpart here.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..kernels import build

# NVIDIA H100 SXM5 80GB at 700 W, from its datasheet (the rates of
# ``kernels/build.py``): 989 TFLOP/s dense bf16 on the tensor cores, 67
# TFLOP/s f32 on the CUDA cores, 1,979 TOPS dense int8, 3.35 TB/s HBM3,
# and 50 GB/s a link: a GPU's 400 Gb/s InfiniBand port, since a 16-wide
# mesh axis spans two 8-GPU nodes; 80 GB of device memory, what "fits"
# is held to
HW_H100 = {"peak_flops": build.BF16_FLOPS_PER_S,
           "f32_flops": build.F32_FLOPS_PER_S,
           "int8_ops": build.INT8_OPS_PER_S,
           "hbm_bw": build.HBM_BYTES_PER_S, "ici_bw": 50e9,
           "hbm_bytes": 80e9}


def rate(dtype: str, hw: Dict = HW_H100) -> float:
    """The peak rate of ops whose first input has ``dtype`` (a name
    such as "bfloat16"): bf16/f16 at the tensor cores' dense peak, int8
    at the int8 peak, anything else at the f32 rate."""
    if dtype in ("bfloat16", "float16"):
        return hw["peak_flops"]
    if dtype in ("int8", "uint8"):
        return hw["int8_ops"]
    return hw["f32_flops"]


def compute_seconds(count: Dict, hw: Dict = HW_H100) -> float:
    """The compute term: the ops' FLOPs by dtype over their rates, plus
    each kernel's operations over the rate of its type."""
    t = sum(f / rate(dt, hw) for dt, f in count["flops_by_dtype"].items())
    return t + sum(k["ops_s"] for k in count.get("kernels", {}).values())


def analyze(count: Dict, mesh, *, arch: str = "", shape: str = "",
            hw: Dict = HW_H100) -> Dict:
    """The reference's ``analyze_compiled`` result keys for a count
    (``configs.base.Cell.count``), ``hlo_bytes_per_device_gb`` renamed
    ``bytes_accessed_per_device_gb``; plus the count's parts and whether
    the cell fits the card's memory."""
    flops = count["flops"]
    bytes_acc = count["bytes_accessed"]
    coll = count["collectives"]
    per_dev = count["arguments"] + count["peak"]
    t_comp = compute_seconds(count, hw)
    t_mem = bytes_acc / hw["hbm_bw"]
    t_coll = coll["wire_bytes"] / hw["ici_bw"]
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    n_dev = mesh.size
    mf = model_flops(arch, shape)
    useful = (mf / n_dev / max(flops, 1.0)) if mf else None
    return {
        "arch": arch, "shape": shape, "devices": n_dev,
        "flops_per_device_tf": flops / 1e12,
        "flops_by_dtype_tf": {k: v / 1e12 for k, v in
                              count["flops_by_dtype"].items()},
        "bytes_accessed_per_device_gb": bytes_acc / 1e9,
        "bytes_per_device_gb": per_dev / 1e9,
        "arguments_gb": count["arguments"] / 1e9,
        "peak_temporaries_gb": count["peak"] / 1e9,
        "outputs_gb": count["outputs"] / 1e9,
        "fits": per_dev <= hw["hbm_bytes"],
        "collective_gb": coll["wire_bytes"] / 1e9,
        "collective_ops": coll["ops"],
        "collective_by_kind": {k: round(v / 1e9, 4)
                               for k, v in coll["by_kind"].items()},
        "dynamic_whiles": len(count.get("notes", [])),
        "notes": count.get("notes", []),
        "kernels": count.get("kernels", {}),
        "t_compute_ms": t_comp * 1e3,
        "t_memory_ms": t_mem * 1e3,
        "t_collective_ms": t_coll * 1e3,
        "dominant": dominant,
        "model_flops_total": mf,
        "useful_flops_ratio": useful,
        "roofline_fraction": (t_comp / max(t_comp, t_mem, t_coll)
                              if max(terms.values()) > 0 else None),
    }


# ---------------------------------------------------------------------------
# MODEL_FLOPS: analytic "useful work" per cell (6ND convention for LM)
# ---------------------------------------------------------------------------

def model_flops(arch: str, shape: str) -> Optional[float]:
    try:
        from ..configs import get_arch
        spec = get_arch(arch)
    except KeyError:
        return None
    cfg = spec.model_config()
    if spec.family == "lm":
        return _lm_model_flops(cfg, shape)
    if spec.family == "gnn":
        return _gnn_model_flops(cfg, shape)
    if spec.family == "recsys":
        return _recsys_model_flops(arch, cfg, shape)
    if spec.family == "ann":
        return _ann_model_flops(cfg, shape)
    return None


def _lm_model_flops(cfg, shape: str) -> float:
    from ..configs.families import LM_SHAPES
    from ..models.transformer import active_param_count
    sh = LM_SHAPES[shape]
    n = active_param_count(cfg)
    b, s = sh["batch"], sh["seq"]
    hdh = cfg.n_heads * cfg.head_dim
    if sh["kind"] == "train":
        # 6ND + causal attention 6 * L * S^2/2 * Hdh * 2(QK+PV) per batch row
        return 6.0 * n * b * s + 6.0 * cfg.n_layers * b * s * s * hdh
    if sh["kind"] == "prefill":
        return 2.0 * n * b * s + 2.0 * cfg.n_layers * b * s * s * hdh
    # decode: one token, full-cache attention
    return 2.0 * n * b + 4.0 * cfg.n_layers * b * s * hdh


def _gnn_model_flops(cfg, shape: str) -> float:
    from ..configs.gnn_archs import GNN_SHAPES
    sh = GNN_SHAPES[shape]
    e = sh["n_edges"] * (2 * sh.get("n_graphs", 1) if "n_graphs" in sh
                         else 1)
    n = sh.get("n_graphs", 1) * sh["n_nodes"] if "n_graphs" in sh \
        else sh["n_nodes"]
    d_in = sh["d_feat"]
    f = 0.0
    for layer in range(cfg.n_layers):
        last = layer == cfg.n_layers - 1
        heads = 1 if last else cfg.n_heads
        d_out = cfg.n_classes if last else cfg.d_hidden
        f += 2.0 * n * d_in * heads * d_out      # projection
        f += 6.0 * e * heads * d_out             # scores+softmax+aggregate
        d_in = d_out * (1 if last else heads)
    return 3.0 * f                                # fwd + bwd


def _recsys_model_flops(arch: str, cfg, shape: str) -> float:
    from ..configs.recsys_archs import RECSYS_SHAPES
    sh = RECSYS_SHAPES[shape]
    b = sh.get("n_cand", sh.get("batch", 1))

    def mlp_flops(dims):
        return sum(2.0 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))

    if arch == "din":
        per = (cfg.seq_len * mlp_flops((4 * cfg.embed_dim,) + cfg.attn_mlp
                                       + (1,))
               + mlp_flops((2 * cfg.embed_dim + cfg.n_dense,) + cfg.mlp
                           + (1,)))
    elif arch == "sasrec":
        d = cfg.embed_dim
        per = cfg.n_blocks * (4 * cfg.seq_len * d * d * 2
                              + 2 * cfg.seq_len * cfg.seq_len * d * 2)
    elif arch == "two-tower-retrieval":
        per = 2 * mlp_flops((cfg.embed_dim,) + cfg.tower_mlp) \
            + 2 * cfg.tower_mlp[-1]
    else:  # dlrm
        f = cfg.n_sparse + 1
        per = (mlp_flops((cfg.n_dense,) + cfg.bot_mlp)
               + 2.0 * f * f * cfg.embed_dim
               + mlp_flops((cfg.n_interactions + cfg.embed_dim,)
                           + cfg.top_mlp))
    mult = 3.0 if sh["kind"] == "train" else 1.0
    return mult * b * per


def _ann_model_flops(dims: Dict, shape: str) -> float:
    from ..configs.quake_arch import QUAKE_SHAPES
    sh = QUAKE_SHAPES[shape]
    p, s_cap, d = dims["p"], dims["s_cap"], dims["d"]
    if sh["kind"] == "assign":
        return 2.0 * sh["n"] * p * d
    b = sh["batch"]
    route = 2.0 * b * p * d
    if sh["kind"] == "fixed":
        return route + 2.0 * b * sh["nprobe"] * s_cap * d
    if sh["kind"] == "brute":
        return 2.0 * b * p * s_cap * d
    # adaptive: nominal 2 rounds x chunk partitions per shard
    return route + 2.0 * b * 2 * 2 * s_cap * d
