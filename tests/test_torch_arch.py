"""The port's architecture registry, sharding specs and roofline against
the JAX package's.

- The registry: the same 11 architectures, families, shapes and smoke
  configs (equal to the port's config modules and, through the
  converters, to the reference's).
- Every argument of every full-size cell on both production meshes: its
  local shape equals ``NamedSharding(AbstractMesh(...), spec).shard_shape``
  of the reference's argument (layer-stacked leaves per layer; the
  engine cells from ``snapshot_spec`` / ``query_spec``, which the
  reference's ``build`` cannot reach without devices), and the per-rank
  argument bytes equal the reference's to the byte.
- ``shard_shape`` on even and uneven splits against JAX's.
- ``model_flops`` equals the reference's for all 44 cells.
- On one CPU device, every smoke cell's arguments equal the reference's
  (the sum of its abstract arguments' bytes), and for one cell of each
  family the count's ``arguments_used`` equals the reference's compiled
  ``memory_analysis().argument_size_in_bytes`` (XLA keeps only the
  arguments the program reads).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.configs import quake_arch as jquake
from repro.core.distributed import EngineConfig as JEngineConfig
from repro.core.distributed import ShardedQuakeEngine as JEngine
from repro.roofline import analysis as janalysis
from repro_torch import configs
from repro_torch.configs import families, gnn_archs, lm_archs, quake_arch
from repro_torch.configs import recsys_archs
from repro_torch.configs.base import dp_axes_for
from repro_torch.launch.mesh import Mesh, P, make_production_mesh, shard_shape
from repro_torch.models.convert import (config_from_jax, gnn_config_from_jax,
                                        recsys_config_from_jax)
from repro_torch.roofline import analysis

MESHES = {"single_pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(n, s) for n, spec in jconfigs.REGISTRY.items() for s in spec.shapes]
# the reference's layer-stacked LM leaves -> the port's per-layer names
LM_LEAVES = {("ln1",): "ln1", ("ln2",): "ln2", ("attn", "wq"): "wq",
             ("attn", "wk"): "wk", ("attn", "wv"): "wv",
             ("attn", "wo"): "wo", ("attn", "bq"): "bq",
             ("attn", "bk"): "bk", ("attn", "bv"): "bv",
             ("mlp", "w_gate"): "w_gate", ("mlp", "w_up"): "w_up",
             ("mlp", "w_down"): "w_down", ("moe", "router"): "moe.router",
             ("moe", "w_gate"): "moe.w_gate", ("moe", "w_up"): "moe.w_up",
             ("moe", "w_down"): "moe.w_down",
             ("shared_mlp", "w_gate"): "shared_mlp.w_gate",
             ("shared_mlp", "w_up"): "shared_mlp.w_up",
             ("shared_mlp", "w_down"): "shared_mlp.w_down"}


def _key_name(path) -> tuple:
    out = []
    for k in path:
        if hasattr(k, "key"):
            out.append(str(k.key))
        elif hasattr(k, "idx"):
            out.append(str(k.idx))
        else:
            out.append(str(getattr(k, "name", k)))
    return tuple(out)


def _ref_args(name, shape, jmesh):
    """(path, global shape, dtype itemsize, shard shape) of each argument
    leaf of the reference's cell, in order."""
    if jconfigs.get_arch(name).family == "ann" and shape != "maint_assign_1m":
        return _ref_engine_args(shape, jmesh)
    low = jconfigs.get_arch(name).build(shape, jmesh)
    leaves = jax.tree_util.tree_leaves_with_path(low.args)
    shs = jax.tree.leaves(low.in_shardings,
                          is_leaf=lambda x: isinstance(x, NamedSharding))
    return [(_key_name(p), tuple(l.shape), l.dtype.itemsize,
             tuple(s.shard_shape(l.shape))) for (p, l), s in zip(leaves, shs)]


def _ref_engine_args(shape, jmesh):
    """The engine cells' arguments from the reference's ``snapshot_spec``
    and ``query_spec`` (its ``__init__`` reads ``mesh.devices``)."""
    sh = jquake.QUAKE_SHAPES[shape]
    dp = tuple(a for a in ("pod", "data") if a in jmesh.axis_names)
    eng = object.__new__(JEngine)
    eng.cfg = JEngineConfig(metric="l2", k=jquake.FULL["k"],
                            nprobe=sh.get("nprobe", 16), part_axes=dp,
                            batch_axis="model")
    eng.batch_axis = "model"
    n_shards = int(np.prod([jmesh.shape[a] for a in dp]))
    snap = jquake._snapshot_sds(jquake.FULL, n_shards)
    q = jax.ShapeDtypeStruct((sh["batch"], jquake.FULL["d"]), np.float32)
    specs = eng.snapshot_spec()
    out = [(("0",), q.shape, 4, NamedSharding(jmesh, eng.query_spec())
            .shard_shape(q.shape))]
    for f in ("data", "ids", "centroids", "sizes", "beta_table"):
        leaf = getattr(snap, f)
        out.append((("1", f), tuple(leaf.shape), leaf.dtype.itemsize,
                    tuple(NamedSharding(jmesh, getattr(specs, f))
                          .shard_shape(leaf.shape))))
    return out


def _port_args(cell):
    """(name path, global shape, itemsize, local shape) of each argument
    leaf of the port's cell, in order."""
    out = []

    def walk(x, path):
        if isinstance(x, configs.base.Arg):
            out.append((path, x.shape,
                        torch.empty((), dtype=x.dtype).element_size(),
                        cell.local_shape(x)))
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, path + (k,))
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for k, v in zip(x._fields, x):
                walk(v, path + (k,))
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, path + (str(i),))
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                if getattr(x, f.name) is not None:
                    walk(getattr(x, f.name), path + (f.name,))
    for i, a in enumerate(cell.args):
        walk(a, (str(i),))
    return out


def _nbytes(rows):
    return sum(int(np.prod(local)) * item for _, _, item, local in rows)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name,shape", CELLS)
def test_argument_shards_equal_reference(name, shape, mesh_name):
    dims, axes = MESHES[mesh_name]
    ref = _ref_args(name, shape, AbstractMesh(dims, axes))
    cell = configs.get_arch(name).build(shape, make_production_mesh(
        mesh_name == "multi_pod"))
    got = _port_args(cell)
    assert _nbytes(got) == _nbytes(ref) == cell.argument_bytes()
    lm = configs.get_arch(name).family == "lm"
    n_layers = sum(1 for k in cell.args[0] if k.endswith(".ln1")) if lm \
        else 1
    want = []
    for path, gshape, _, local in ref:
        stem = LM_LEAVES.get(path[-2:], LM_LEAVES.get(path[-1:])) if lm \
            else None
        if stem is not None:    # a layer-stacked leaf: L of the port's
            pre = ".".join(path[:-2] if "." in stem or path[-2] in (
                "attn", "mlp") else path[:-1])
            want += [(pre, stem, gshape[1:], local[1:])] * n_layers
        else:
            want.append((".".join(path[:-1]), path[-1], gshape, local))
    got_rows = []
    for path, gshape, _, local in got:
        name_ = ".".join(path)
        if lm and ".blocks." in name_:
            pre, rest = name_.split(".blocks.", 1)
            got_rows.append((pre, rest.split(".", 1)[1], gshape, local))
        else:
            full = name_.split(".")
            got_rows.append((".".join(full[:-1]), full[-1], gshape, local))
    assert sorted(got_rows) == sorted(want)


def test_motivation_table_to_the_byte():
    want = {("qwen2.5-14b", "train_4k"): (0.699, 0.353),
            ("qwen2.5-14b", "prefill_32k"): (0.233, 0.118),
            ("qwen2.5-14b", "decode_32k"): (3.454, 1.728),
            ("qwen2.5-14b", "long_500k"): (0.635, 0.319),
            ("mistral-large-123b", "train_4k"): (5.774, 2.900),
            ("qwen3-moe-235b-a22b", "train_4k"): (11.064, 5.537),
            ("llama4-scout-17b-a16e", "decode_32k"): (4.908, 2.455),
            ("granite-34b", "decode_32k"): (1.481, 0.743),
            ("gat-cora", "ogb_products"): (1.020, 1.005),
            ("dlrm-rm2", "train_batch"): (6.251, 6.250),
            ("two-tower-retrieval", "train_batch"): (3.843, 3.842),
            ("quake-ann", "maint_assign_1m"): (0.040, 0.024)}
    for (name, shape), gb in want.items():
        for multi, g in zip((False, True), gb):
            cell = configs.get_arch(name).build(shape,
                                                make_production_mesh(multi))
            assert round(cell.argument_bytes() / 1e9, 3) == g, (name, shape)


def test_registry_matches_reference():
    assert list(configs.REGISTRY) == list(jconfigs.REGISTRY)
    for name, spec in configs.REGISTRY.items():
        ref = jconfigs.get_arch(name)
        assert (spec.family, spec.shapes, spec.source) == \
            (ref.family, ref.shapes, ref.source)
        for which in ("model_config", "smoke_config"):
            got, want = getattr(spec, which)(), getattr(ref, which)()
            fields = dataclasses.asdict(want) if dataclasses.is_dataclass(
                want) else want
            if spec.family == "lm":
                assert config_from_jax(fields) == got
            elif spec.family == "gnn":
                assert gnn_config_from_jax(fields) == got
            elif spec.family == "recsys":
                assert recsys_config_from_jax(name, fields) == got
            else:
                assert fields == got
    # the smoke configs are the port's config modules' own
    assert configs.get_arch("qwen2.5-14b").smoke_config() == \
        lm_archs.qwen25_smoke()
    assert configs.get_arch("gat-cora").smoke_config() == \
        gnn_archs.gat_cora_smoke()
    assert configs.get_arch("dlrm-rm2").smoke_config() == \
        recsys_archs.dlrm_smoke()
    assert families.LM_SHAPES == jconfigs.families.LM_SHAPES
    assert families.LM_SMOKE_SHAPES == jconfigs.families.LM_SMOKE_SHAPES
    assert quake_arch.QUAKE_SHAPES == jquake.QUAKE_SHAPES
    assert quake_arch.FULL == jquake.FULL


@pytest.mark.parametrize("name,shape", CELLS)
def test_model_flops_equal_reference(name, shape):
    assert analysis.model_flops(name, shape) == \
        janalysis.model_flops(name, shape)


@pytest.mark.parametrize("n,spec", [
    (40, P("model")), (152064, P("model")), (5, P("model")),
    (524288, P(("data", "model"))), (1, P("data")), (7, P(None))])
def test_shard_shape_matches_jax(n, spec):
    jm = AbstractMesh((16, 16), ("data", "model"))
    mesh = make_production_mesh()
    jspec = JP(*spec)
    try:
        want = NamedSharding(jm, jspec).shard_shape((n, 3))
    except ValueError:
        with pytest.raises(ValueError):
            shard_shape((n, 3), spec, mesh)
        return
    assert shard_shape((n, 3), spec, mesh) == tuple(want)


def test_production_mesh_coordinates():
    m = make_production_mesh(True, rank=300)
    assert m.size == 512 and m.axis_names == ("pod", "data", "model")
    assert m.coords == {"pod": 1, "data": 2, "model": 12}
    assert m.index(("pod", "data")) == 18
    assert m.device.type == "meta"
    with pytest.raises(ValueError, match="not in a mesh"):
        make_production_mesh(rank=256)


# one cell a family is compiled by XLA (a compile takes seconds)
COMPILED = {("gat-cora", "molecule"), ("qwen2.5-14b", "decode_32k"),
            ("dlrm-rm2", "serve_p99"), ("quake-ann", "maint_assign_1m")}


@pytest.mark.parametrize("name,shape", CELLS)
def test_smoke_arguments_equal_reference_on_one_device(name, shape):
    jm = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                           ("data", "model"))
    mesh = Mesh((1, 1), ("data", "model"), device="cpu")
    spec = jconfigs.get_arch(name)
    if spec.family == "ann" and shape != "maint_assign_1m":
        low = None
        dims = jquake.SMOKE
        sh = jquake.QUAKE_SMOKE_SHAPES[shape]
        snap = jquake._snapshot_sds(dims, 1)
        want = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                   for x in jax.tree.leaves(snap)) \
            + sh["batch"] * dims["d"] * 4
    else:
        low = spec.build(shape, jm, smoke=True)
        want = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                   for x in jax.tree.leaves(low.args))
    cell = configs.get_arch(name).build(shape, mesh, smoke=True)
    assert cell.argument_bytes() == want
    if (name, shape) in COMPILED:
        # XLA keeps the arguments the program reads (DLRM reads no
        # history): the count's ``arguments_used``
        mem = low.lower().compile().memory_analysis()
        got = cell.count()
        assert got["arguments"] == want
        assert got["arguments_used"] == mem.argument_size_in_bytes


def test_dp_axes_for_meshes():
    assert dp_axes_for(make_production_mesh()) == ("data",)
    assert dp_axes_for(make_production_mesh(True)) == ("pod", "data")
