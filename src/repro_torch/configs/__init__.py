"""Model configurations and the architecture registry.

The plain data: the LM architectures (``lm_archs``), the recsys
architectures with their serving and training shapes (``recsys_archs``),
the GAT with its graph shapes (``gnn_archs``) and the training cells'
optimizer and LM shapes (``training``).

The registry (the reference's ``configs/__init__.py``): the ten assigned
architectures plus ``quake-ann``, four shapes each.
``get_arch(name).build(shape, mesh, smoke=...)`` returns a ``Cell`` for
any (arch x shape x mesh) cell; ``all_cells()`` enumerates the table.
"""
from . import gnn_archs, lm_archs, recsys_archs, training
from .base import (REGISTRY, ArchSpec, Cell, all_cells,  # noqa: F401
                   get_arch, register)
from .families import LM_SHAPES, build_gnn, build_lm, build_recsys

LM_SOURCES = (
    ("mistral-large-123b", "hf:mistralai/Mistral-Large-Instruct-2407",
     "mistral_large_123b", "mistral_large_smoke", "dense 88L GQA kv=8", 4),
    ("granite-34b", "arXiv:2405.04324", "granite_34b", "granite_smoke",
     "dense 88L MQA (kv=1), code model", 2),
    ("qwen2.5-14b", "hf:Qwen/Qwen2.5-14B", "qwen25_14b", "qwen25_smoke",
     "dense 48L GQA kv=8, QKV bias, 152k vocab", 2),
    ("qwen3-moe-235b-a22b", "hf:Qwen/Qwen3-235B-A22B", "qwen3_moe_235b",
     "qwen3_moe_smoke", "MoE 128e top-8, 94L", 2),
    ("llama4-scout-17b-a16e", "hf:meta-llama/Llama-4-Scout-17B-16E",
     "llama4_scout", "llama4_scout_smoke",
     "MoE 16e top-1 + shared expert; modality frontend stubbed", 2),
)
RECSYS_SOURCES = (
    ("din", "arXiv:1706.06978",
     "target-attention over user history; 10M-row table"),
    ("sasrec", "arXiv:1808.09781",
     "self-attentive sequential; in-batch softmax loss"),
    ("two-tower-retrieval", "RecSys'19 (YouTube)",
     "sampled-softmax retrieval with logQ correction; retrieval_cand is "
     "Quake's direct use case"),
    ("dlrm-rm2", "arXiv:1906.00091",
     "26 row-sharded 5M-row tables; dot interaction"),
)


def _lm_build(full_fn, smoke_fn, microbatches):
    def build(shape, mesh, smoke=False, **kw):
        return build_lm((smoke_fn if smoke else full_fn)(), shape, mesh,
                        smoke=smoke, **({"microbatches": microbatches} | kw))
    return build


def _recsys_build(name, full_fn, smoke_fn):
    def build(shape, mesh, smoke=False):
        return build_recsys(name, (smoke_fn if smoke else full_fn)(), shape,
                            mesh, smoke=smoke)
    return build


register(ArchSpec(
    name="gat-cora", family="gnn", source="arXiv:1710.10903",
    shapes=tuple(gnn_archs.GNN_SHAPES),
    model_config=gnn_archs.gat_cora, smoke_config=gnn_archs.gat_cora_smoke,
    build=lambda shape, mesh, smoke=False: build_gnn(
        (gnn_archs.gat_cora_smoke if smoke else gnn_archs.gat_cora)(),
        shape, mesh, smoke=smoke),
    notes="SDDMM->edge-softmax->SpMM via segment ops; edge-parallel"))
for _name, _src, _full, _smoke, _notes, _mb in LM_SOURCES:
    register(ArchSpec(
        name=_name, family="lm", source=_src, shapes=tuple(LM_SHAPES),
        model_config=getattr(lm_archs, _full),
        smoke_config=getattr(lm_archs, _smoke),
        build=_lm_build(getattr(lm_archs, _full), getattr(lm_archs, _smoke),
                        _mb),
        notes=_notes))
from . import quake_arch  # noqa: E402,F401  (registers quake-ann here)
for _name, _src, _notes in RECSYS_SOURCES:
    _full, _smoke = recsys_archs.ARCHS[_name]
    register(ArchSpec(
        name=_name, family="recsys", source=_src,
        shapes=tuple(recsys_archs.RECSYS_SHAPES), model_config=_full,
        smoke_config=_smoke, build=_recsys_build(_name, _full, _smoke),
        notes=_notes))

__all__ = ["REGISTRY", "ArchSpec", "Cell", "all_cells", "get_arch",
           "gnn_archs", "lm_archs", "recsys_archs", "register", "training"]
