"""The per-rank programs of the registry's cells against the JAX
package's cells and the one-device port, on the CPU.

- Every smoke cell's per-rank program on a one-rank mesh equals the
  reference's cell (its ``Lowering``'s jitted function on a (1, 1) JAX
  mesh) on the same arguments, the port's drawn from a seed and handed to
  the reference through the converters' names; and equals the
  one-device port: a train step's loss, gradient norm and parameters
  within 1e-5 * |x| + 1e-5; prefill and decode logits and caches, recsys
  serve and retrieval scores, the GAT's step likewise; the engine's
  per-rank searches equal its public entry points, and brute force the
  exact top-k; the assignment equals the oracle's.
- Four gloo ranks on a (1, 2, 2) mesh (one set of four ``python -c``
  processes for all cells) give each rank its slice of the one-rank
  result (``scripts/cell_ranks.py``'s ``rank_results``, whose docstring
  states the tolerances, and which the script runs on four NCCL cards),
  and its slice of the reference's cell on four JAX host devices as a
  (1, 2, 2) mesh, run beside them in a fifth process on the same
  arguments.
- Against the reference (``ref_excess``): a step's loss within 1e-5 of
  it relative, its gradient norm 1e-4, its lr 1e-7, the step count
  equal, each parameter after the step within 1e-5 * |p| + 1e-6 (2 lr
  where the reference's first moment is under 1e-3 of its leaf's
  largest: there the sign of a tiny gradient decides AdamW's first
  update), the moments within 1e-4 of their leaf's largest (+ 1e-6 for
  m, 1e-12 for v), as ``test_torch_train.py`` holds a step; decode
  within 2^-8 * |x| + 1e-3 (its cache is bf16); everything else within
  1e-5 * |x| + 1e-5, and ids equal.
- A process-group mesh records no collective outside a count.
- The collectives the production mesh records for the GAT and engine
  cells match their counts worked by hand.
"""
import contextlib
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro_torch import configs
from repro_torch.core.distributed import ShardedQuakeEngine
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import gnn, recsys
from repro_torch.models import transformer as tr
from repro_torch.train import steps
from repro_torch.configs.training import OPT_CFG
from repro_torch.models.convert import named_from_jax
from repro_torch.train.optimizer import AdamWState

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
from cell_ranks import DECODE_ABS, DECODE_REL, SEED  # noqa: E402
from cell_ranks import cell_kind, expected_piece  # noqa: E402
from cell_ranks import clone as _clone  # noqa: E402
from cell_ranks import max_excess as _max_excess  # noqa: E402
from test_torch_arch import LM_LEAVES  # noqa: E402

CELLS = [(n, s) for n, spec in configs.REGISTRY.items() for s in spec.shapes]


def one_device(name, cell, args):
    """The one-device port's result on the cell's (whole) arguments."""
    spec = configs.get_arch(name)
    cfg = cell.config
    if spec.family == "lm":
        model = tr.Transformer(cfg, device="cpu", init=False)
        model.load_state_dict(args[0])
        if len(args) == 3:
            step = steps.make_train_step(
                lambda m, b: tr.lm_loss_chunked(m, b["tokens"], chunk=512),
                OPT_CFG)
            m, st, metrics = step(model, args[1], args[2])
            return dict(m.named_parameters()), st, metrics
        if len(args) == 2:
            return model.prefill(args[1])
        return model.decode_step(*args[1:])
    if spec.family == "gnn":
        model = gnn.GAT(cfg, device="cpu", init=False)
        model.load_state_dict(args[0])
        b = args[2]
        if "graph_of" in b:
            n_graphs = b["labels"].shape[0]

            def loss(m, b):
                return gnn.pooled_loss(m, b["feats"], b["src"], b["dst"],
                                       b["graph_of"], b["labels"], n_graphs)
        else:
            def loss(m, b):
                return gnn.loss_fn(m, b["feats"], b["src"], b["dst"],
                                   b["labels"])
        m, st, metrics = steps.make_train_step(loss, OPT_CFG)(model,
                                                              args[1], b)
        return dict(m.named_parameters()), st, metrics
    if spec.family == "recsys":
        model = recsys.MODELS[name][1](cfg, device="cpu", init=False)
        model.load_state_dict(args[0])
        if len(args) == 3 and isinstance(args[1], tuple):
            m, st, metrics = steps.make_train_step(recsys.recsys_loss,
                                                   OPT_CFG)(model, *args[1:])
            return dict(m.named_parameters()), st, metrics
        if len(args) == 2:
            return recsys.recsys_serve(model, args[1])
        return recsys.recsys_retrieval(model, args[1], args[2])
    # quake-ann
    if isinstance(cfg, dict):
        return ops.kmeans_assign(args[0], args[1], impl="torch")
    eng = ShardedQuakeEngine(Mesh((1, 1), ("data", "model"), device="cpu"),
                             cfg)
    kind = cell.description.split()[1]
    return {"fixed": eng.search_fixed, "adaptive": eng.search_adaptive,
            "brute": eng.search_bruteforce}[kind](*args)


@pytest.mark.parametrize("name,shape", CELLS)
def test_one_rank_program_equals_one_device_port(name, shape):
    cell = configs.get_arch(name).build(
        shape, Mesh((1, 1), ("data", "model"), device="cpu"), smoke=True)
    args = cell.materialize("cpu", torch.Generator().manual_seed(7))
    got = cell.fn(*_clone(args))
    want = one_device(name, cell, _clone(args))
    if isinstance(cell.config, dict):          # the assignment
        assert torch.equal(got[0], want[0])
        assert _max_excess(got[1], want[1]) <= 0
        return
    if configs.get_arch(name).family == "ann":
        assert _max_excess(got[0], want[0]) <= 0
        assert torch.equal(got[1], want[1])
        if "brute" in cell.description:          # against the exact top-k
            q, snap = args
            x = snap.data.reshape(-1, snap.data.shape[-1])
            d = torch.cdist(q.double(), x.double()) ** 2
            exact = torch.topk(d, got[0].shape[1], largest=False).values
            assert torch.allclose(got[0].double(), exact, rtol=1e-4,
                                  atol=1e-3)
        return
    assert _max_excess(got, want) <= 0


# ---------------------------------------------------------------------------
# the reference's cells on the port's arguments
# ---------------------------------------------------------------------------

LOSS_REL, NORM_REL, LR_REL = 1e-5, 1e-4, 1e-7
P_REL, P_ABS, SMALL = 1e-5, 1e-6, 1e-3
M_REL, M_ABS, V_ABS = 1e-4, 1e-6, 1e-12
TOL = 1e-5
JAX_FLAGS = ("--xla_force_host_platform_device_count=4 "
             # XLA's CPU thunk runtime has no bf16 x bf16 -> f32 dot,
             # which the reference's decode makes of its bf16 cache
             "--xla_cpu_use_thunk_runtime=false "
             "--xla_cpu_multi_thread_eigen=false "
             "intra_op_parallelism_threads=1")


def _jarr(t: torch.Tensor, dtype):
    a = t.detach().float().numpy() if t.is_floating_point() \
        else t.numpy()
    return jax.numpy.asarray(a, dtype)


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _params_to_jax(sds, named, cfg):
    """The port's parameters by name as the reference's tree ``sds``
    (the LM's per-layer leaves stacked)."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(sds)
    leaves = []
    for path, s in flat:
        keys = tuple(getattr(k, "key", getattr(k, "idx", None))
                     for k in path)
        if isinstance(cfg, tr.TransformerConfig) \
                and keys[0] not in ("embed", "ln_f", "lm_head"):
            t = torch.stack([named[f"blocks.{i}.{LM_LEAVES[keys]}"]
                             for i in range(cfg.n_layers)])
        else:
            t = named[".".join(str(k) for k in keys)]
        assert tuple(t.shape) == tuple(s.shape), (keys, t.shape, s.shape)
        leaves.append(_jarr(t, s.dtype))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _to_jax(sds, t, cfg):
    """The port's argument ``t`` as the reference's argument ``sds``."""
    if isinstance(sds, jax.ShapeDtypeStruct):
        assert tuple(t.shape) == tuple(sds.shape), (t.shape, sds.shape)
        return _jarr(t, sds.dtype)
    if isinstance(t, AdamWState):
        return type(sds)(step=_to_jax(sds.step, t.step, cfg),
                         m=_params_to_jax(sds.m, t.m, cfg),
                         v=_params_to_jax(sds.v, t.v, cfg))
    if isinstance(sds, dict) and set(sds) == set(t):
        return {k: _to_jax(v, t[k], cfg) for k, v in sds.items()}
    if isinstance(sds, dict):                       # parameters by name
        return _params_to_jax(sds, t, cfg)
    if isinstance(sds, (tuple, list)):
        return type(sds)(_to_jax(a, b, cfg) for a, b in zip(sds, t))
    return type(sds)(**{f: None if getattr(sds, f) is None else _to_jax(
        getattr(sds, f), getattr(t, f), cfg) for f in vars(sds)})


def reference_result(name, shape, jmesh, cell, full):
    """The reference's cell ``(name, shape)`` on the JAX mesh ``jmesh``,
    run on the port's whole arguments ``full`` of ``cell``; its outputs
    in the port's structure and names."""
    low = jconfigs.get_arch(name).build(shape, jmesh, smoke=True)
    args = jax.device_put(
        tuple(_to_jax(s, t, cell.config) for s, t in zip(low.args, full)),
        low.in_shardings)
    ctx = jax.set_mesh(low.mesh) if low.mesh is not None \
        else contextlib.nullcontext()
    with ctx:
        out = jax.jit(low.fn, in_shardings=low.in_shardings)(*args)
    kind = cell_kind(name, cell)
    if kind == "train":
        lm = cell.config if isinstance(cell.config, tr.TransformerConfig) \
            else None

        def named(tree):
            return {k: torch.from_numpy(a)
                    for k, a in named_from_jax(tree, lm).items()}
        params, st, metrics = out
        return (named(params),
                AdamWState(torch.tensor(int(st.step), dtype=torch.int32),
                           named(st.m), named(st.v)),
                {k: torch.tensor(float(metrics[k]))
                 for k in ("loss", "grad_norm", "lr")})
    leaves = [_tensor(a) for a in jax.tree.leaves(out)]
    if kind in ("prefill", "decode"):
        return leaves[0], (leaves[1], leaves[2])
    if kind in ("serve", "retrieval"):
        return leaves[0]
    return tuple(leaves)


def _excess(got, want, rel, abs_) -> float:
    g, w = got.double(), want.double()
    assert g.shape == w.shape, (tuple(g.shape), tuple(w.shape))
    if not w.numel():
        return -1.0
    return float(((g - w).abs() - rel * w.abs() - abs_).max())


def ref_excess(kind: str, got, want) -> float:
    """The largest excess of ``got`` over the reference's ``want`` by the
    module docstring's tolerances (<= 0 holds)."""
    if kind == "train":
        (p, st, m), (wp, wst, wm) = got, want
        lr = float(wm["lr"])
        worst = max(_excess(m["loss"], wm["loss"], LOSS_REL, 0),
                    _excess(m["grad_norm"], wm["grad_norm"], NORM_REL, 0),
                    _excess(m["lr"], wm["lr"], LR_REL, 0),
                    0.0 if int(st.step) == int(wst.step) else 1.0)
        assert set(p) == set(wp) == set(st.m) == set(wst.m)
        for n, w in wp.items():
            g = p[n].detach().double()
            mw = wst.m[n].double()
            small = mw.abs() < SMALL * mw.abs().max()
            tol = torch.where(small, 2.0 * lr,
                              P_REL * w.double().abs() + P_ABS)
            worst = max(worst, float(((g - w.double()).abs() - tol).max()),
                        _excess(st.m[n], mw, 0,
                                M_REL * float(mw.abs().max()) + M_ABS),
                        _excess(st.v[n], wst.v[n], 0, M_REL * float(
                            wst.v[n].abs().max()) + V_ABS))
        return worst
    if kind == "decode":
        return _max_excess(got, want, DECODE_REL, DECODE_ABS)
    if kind in ("fixed", "adaptive", "brute", "assign"):
        ids = 0 if kind == "assign" else 1     # (assignment, distance)
        same = torch.equal(got[ids], want[ids])
        rest = [_max_excess(g, w, TOL, TOL) for i, (g, w) in
                enumerate(zip(got, want)) if i != ids]
        return max(rest + [-1.0 if same else 1.0])
    return _max_excess(got, want, TOL, TOL)


REF_WORKER = textwrap.dedent("""
    import sys, torch
    sys.path[:0] = [{src!r}, {scripts!r}, {tests!r}]
    torch.set_num_threads(1)
    import test_torch_spmd as t
    t.reference_results({out!r}, {which!r})
""")


def reference_results(path: str, which: str) -> None:
    """Every smoke cell of the reference, saved to ``path`` ({cell:
    outputs}): with ``which`` "one" on a (1, 1) JAX mesh on the one-rank
    test's arguments, with "four" on four JAX host devices as a (1, 2, 2)
    mesh on ``cell_ranks.rank_results``'s."""
    from repro_torch.launch.mesh import Mesh as TMesh
    devs = np.array(jax.devices())
    if which == "one":
        jmesh = jax.sharding.Mesh(devs[:1].reshape(1, 1), ("data", "model"))
        mesh, seed = TMesh((1, 1), ("data", "model"), device="cpu"), 7
    else:
        jmesh = jax.sharding.Mesh(devs[:4].reshape(1, 2, 2),
                                  ("pod", "data", "model"))
        mesh = TMesh((1, 1, 1), ("pod", "data", "model"), device="cpu",
                     rank=0)
        seed = SEED
    res = {}
    for name, shape in CELLS:
        cell = configs.get_arch(name).build(shape, mesh, smoke=True)
        full = cell.materialize("cpu", torch.Generator().manual_seed(seed))
        res[f"{name}/{shape}"] = reference_result(name, shape, jmesh, cell,
                                                  full)
    torch.save(res, path)


# ---------------------------------------------------------------------------
# four gloo ranks beside four JAX host devices
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent("""
    import json, sys, torch, torch.distributed as dist
    sys.path.insert(0, {src!r}); sys.path.insert(0, {scripts!r})
    rank = int(sys.argv[1])
    dist.init_process_group("gloo", init_method={init!r}, rank=rank,
                            world_size=4)
    torch.set_num_threads(1)
    import cell_ranks
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((1, 2, 2), ("pod", "data", "model"), device="cpu")
    outputs = {{}}
    out = cell_ranks.rank_results("cpu", mesh, outputs)
    # a process-group mesh records nothing outside a count
    out["records"] = len(mesh.records)
    with open({out!r} + f".{{rank}}.json", "w") as f:
        json.dump(out, f)
    torch.save(outputs, {out!r} + f".{{rank}}.pt")
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One set of four gloo ranks running every smoke cell, and beside
    them two processes running the reference's cells (``REF_WORKER``):
    {"ranks": [(excesses, outputs)] * 4, "ref": reference_results'}."""
    tmp = tmp_path_factory.mktemp("spmd")
    init = f"file://{tmp / 'init'}"
    outp = str(tmp / "res")
    fmt = dict(src=str(ROOT / "src"), scripts=str(ROOT / "scripts"),
               tests=str(ROOT / "tests"), init=init, out=outp)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER.format(**fmt),
                               str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for r in range(4)]
    for which in ("one", "four"):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", REF_WORKER.format(**dict(
                fmt, out=str(tmp / f"{which}.pt"), which=which))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=dict(env, XLA_FLAGS=JAX_FLAGS)))
    try:
        logs = [p.communicate(timeout=600)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {r}:\n{log[-4000:]}"
    return {"ranks": [(json.loads(Path(f"{outp}.{r}.json").read_text()),
                       torch.load(f"{outp}.{r}.pt", weights_only=False))
                      for r in range(4)],
            "ref": {w: torch.load(tmp / f"{w}.pt", weights_only=False)
                    for w in ("one", "four")}}


@pytest.mark.parametrize("name,shape", CELLS)
def test_one_rank_program_equals_reference(runs, name, shape):
    cell = configs.get_arch(name).build(
        shape, Mesh((1, 1), ("data", "model"), device="cpu"), smoke=True)
    args = cell.materialize("cpu", torch.Generator().manual_seed(7))
    got = cell.fn(*_clone(args))
    want = runs["ref"]["one"][f"{name}/{shape}"]
    assert ref_excess(cell_kind(name, cell), got, want) <= 0


def test_four_gloo_ranks_match_one_rank(runs):
    for r, (res, _) in enumerate(runs["ranks"]):
        assert set(res) == {f"{n}/{s}" for n, s in CELLS} | {"records"}
        bad = {k: v for k, v in res.items() if k != "records" and v > 0}
        assert not bad, f"rank {r}: {bad}"


def test_process_group_mesh_records_nothing_outside_a_count(runs):
    assert [res["records"] for res, _ in runs["ranks"]] == [0] * 4


@pytest.mark.parametrize("name,shape", CELLS)
def test_four_gloo_ranks_match_four_jax_devices(runs, name, shape):
    key = f"{name}/{shape}"
    want = runs["ref"]["four"][key]
    for r, (_, outputs) in enumerate(runs["ranks"]):
        mesh = Mesh((1, 2, 2), ("pod", "data", "model"), device="cpu",
                    rank=r)
        cell = configs.get_arch(name).build(shape, mesh, smoke=True)
        kind = cell_kind(name, cell)
        exp = expected_piece(cell, want, mesh)
        assert ref_excess(kind, outputs[key], exp) <= 0, f"rank {r}"


# ---------------------------------------------------------------------------
# the recorded collectives, by hand
# ---------------------------------------------------------------------------

def _records(cell):
    cell.count()
    return cell.mesh.records


def test_gat_collectives_by_hand():
    mesh = make_production_mesh()
    cell = configs.get_arch("gat-cora").build("full_graph_sm", mesh)
    recs = _records(cell)
    n, heads, hid, cls = 2708, 8, 8, 7
    want = []
    for h_, d_ in ((heads, hid), (1, cls)):   # forward, layer by layer
        want += [("all-reduce", "forward", n * h_ * 4),       # pmax
                 ("all-reduce", "forward", n * h_ * 4),       # denominator
                 ("all-reduce", "forward", n * h_ * d_ * 4)]  # messages
    # backward, last layer first: the denominator's and the node
    # tensors' pvary, summing their gradients over the edge shards
    for h_, d_ in ((1, cls), (heads, hid)):
        want += [("all-reduce", "backward", n * h_ * 4),
                 ("all-reduce", "backward", h_ * d_ * 4),
                 ("all-reduce", "backward", h_ * d_ * 4),
                 ("all-reduce", "backward", n * h_ * d_ * 4)]
    got = [(r["kind"], r["pass"], r["bytes"]) for r in recs]
    assert sorted(got) == sorted(want)
    assert all(r["n"] == 16 and r["axes"] == ("data",) for r in recs)
    total = sum(2 * b * 15 / 16 for _, _, b in want)
    assert cell.mesh.collective_totals()["wire_bytes"] == pytest.approx(
        total)


@pytest.mark.parametrize("shape,n_ag,n_ar", [
    ("serve_fixed_1k", 2, 0), ("bulk_brute_8k", 2, 0),
    # adaptive: pmin, 2 psums for c0; per round the merge (2 gathers) and
    # 3 psums of the recall estimate; before each later round one psum
    # of the unscanned count; the final merge and the nprobe psum
    ("serve_adaptive_1k", 2 * 16 + 2, 3 + 3 * 16 + 15 + 1)])
def test_engine_collectives_by_hand(shape, n_ag, n_ar):
    mesh = make_production_mesh()
    cell = configs.get_arch("quake-ann").build(shape, mesh)
    recs = _records(cell)
    ag = [r for r in recs if r["kind"] == "all-gather"]
    ar = [r for r in recs if r["kind"] == "all-reduce"]
    assert (len(ag), len(ar), len(recs)) == (n_ag, n_ar, n_ag + n_ar)
    b_loc, k = (8192 if "brute" in shape else 1024) // 16, 100
    for r in ag:      # (B_loc, k) f32 distances or int32 ids, 16 shards
        assert r["bytes"] == b_loc * k * 4 * 16 and r["n"] == 16
        assert r["wire_bytes"] == pytest.approx(r["bytes"] * 15 / 16)
    if shape == "serve_adaptive_1k":
        assert cell.mesh.notes and "16 rounds" in cell.mesh.notes[0]
