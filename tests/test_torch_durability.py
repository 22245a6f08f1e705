"""The port's durability against the JAX package's: the WAL and checkpoint
byte format is shared, so a checkpoint and WAL written by either package
are recovered by the other with an equal ``index_state_fingerprint``.
Also the torn-tail truncation, the fallback past a damaged generation,
and equal fingerprints after the same op stream in both packages.

Both indexes start from one structure: the JAX index is built, and the
port's is loaded from its arrays (``index_from_arrays``), so k-means in
two frameworks cannot hide a difference.  The op stream's inserts are
jittered copies of resident vectors, far from any routing tie.
"""
import copy
import os

import numpy as np
import pytest

from repro.core import QuakeConfig as JConfig
from repro.core import QuakeIndex as JIndex
from repro.core import ServingConfig as JServingConfig
from repro.core import ServingRuntime as JRuntime
from repro.core import durability as jdur
from repro.data import datasets as jds
from repro.faults import FaultInjector as JFaults
from repro.faults import InjectedFault as JInjectedFault
from repro.faults import index_state_fingerprint as jfingerprint
from repro_torch.core import ServingConfig, ServingRuntime
from repro_torch.core import durability as dur
from repro_torch.core.convert import index_from_arrays
from repro_torch.faults import FaultInjector, InjectedFault
from repro_torch.faults import index_state_fingerprint as fingerprint
from test_torch_core import export_jax_index


@pytest.fixture(scope="module")
def ds():
    return jds.clustered(3000, 16, n_clusters=12, seed=0)


@pytest.fixture(scope="module")
def jbase(ds):
    return JIndex.build(ds.vectors[:2000], num_partitions=16, kmeans_iters=3,
                        config=JConfig(recall_target=0.9))


def port_of(j):
    return index_from_arrays(export_jax_index(j), device="cpu")


def make_ops(ds, n_ops=18, seed=123):
    """Inserts with fresh ids and deletes of disjoint base-id slices (the
    JAX durability tests' stream)."""
    rng = np.random.default_rng(seed)
    ops, nxt, del_base = [], 50_000, 1900
    for i in range(n_ops):
        if i % 6 == 5:
            ops.append(("delete", np.arange(del_base, del_base + 5)))
            del_base += 5
        else:
            x = (ds.vectors[rng.integers(2000, size=8)]
                 + rng.normal(0, 0.01, (8, ds.vectors.shape[1]))
                 ).astype(np.float32)
            ops.append(("insert", x, np.arange(nxt, nxt + 8)))
            nxt += 8
    return ops


@pytest.fixture(scope="module")
def ops(ds):
    return make_ops(ds)


def serve_writes(rt, ops):
    for op in ops:
        if op[0] == "insert":
            rt.submit_insert(op[1], op[2])
        else:
            rt.submit_delete(op[1])


def _cfg(cls, **kw):
    # the cadence checkpoint lands mid-stream, so recovery replays a
    # WAL suffix on top of a checkpoint that is not the baseline
    return cls(k=5, maint_min_ops=10 ** 9, maint_max_ops=None,
               ckpt_every_ops=7, fsync="batch", wal_batch_ops=4, **kw)


def test_same_op_stream_same_fingerprint(jbase, ops):
    j, p = copy.deepcopy(jbase), port_of(jbase)
    assert fingerprint(p) == jfingerprint(j)
    for op in ops:
        for idx in (j, p):
            if op[0] == "insert":
                idx.insert(op[1], op[2])
            else:
                idx.delete(op[1])
        assert fingerprint(p) == jfingerprint(j)


def test_reference_wal_and_checkpoint_recovered_by_port(tmp_path, jbase,
                                                        ops):
    j = copy.deepcopy(jbase)
    rt = JRuntime(j, _cfg(JServingConfig, wal_dir=str(tmp_path)))
    serve_writes(rt, ops)
    live = jfingerprint(j)
    st = rt.stats()["durability"]
    rt.close()
    assert st["checkpoints_written"] >= 2
    idx, rep = dur.recover_index(str(tmp_path), device="cpu")
    assert fingerprint(idx) == live
    assert rep.fingerprint == live.hex()
    assert rep.records_replayed >= 1 and rep.write_ops_recovered == len(ops)
    idx.check_invariants()
    assert idx.device.type == "cpu"
    # QuakeIndex.load is the same path
    from repro_torch.core import QuakeIndex
    assert fingerprint(QuakeIndex.load(str(tmp_path), device="cpu")) == live


def test_port_wal_and_checkpoint_recovered_by_reference(tmp_path, jbase, ops):
    p = port_of(jbase)
    rt = ServingRuntime(p, _cfg(ServingConfig, wal_dir=str(tmp_path)))
    serve_writes(rt, ops)
    live = fingerprint(p)
    rt.close()
    idx, rep = jdur.recover_index(str(tmp_path))
    assert jfingerprint(idx) == live
    assert rep.fingerprint == live.hex()
    assert rep.write_ops_recovered == len(ops)
    # and the port's own recovery, through the runtime
    rt2 = ServingRuntime.recover(str(tmp_path), _cfg(ServingConfig),
                                 device="cpu")
    assert fingerprint(rt2.index) == live
    assert rt2.recovery_report.fingerprint == live.hex()
    rt2.close()


def test_checkpoint_and_wal_bytes_equal(tmp_path, jbase, ops):
    """On one index state the two packages write the same bytes: every
    checkpoint file, and the WAL's frames."""
    j, p = copy.deepcopy(jbase), port_of(jbase)
    for idx in (j, p):
        for op in ops[:4]:
            if op[0] == "insert":
                idx.insert(op[1], op[2])
            else:
                idx.delete(op[1])
    jdir, pdir = tmp_path / "j", tmp_path / "p"
    jdir.mkdir()
    pdir.mkdir()
    jman, _ = jdur.write_checkpoint(j, str(jdir), 3, wal_lsn=9,
                                    write_op_count=4)
    pman, _ = dur.write_checkpoint(p, str(pdir), 3, wal_lsn=9,
                                   write_op_count=4)
    assert jman == pman
    gen = "ckpt-00000003"
    names = sorted(os.listdir(jdir / gen))
    assert names == sorted(os.listdir(pdir / gen))
    for name in names:
        assert (jdir / gen / name).read_bytes() == \
            (pdir / gen / name).read_bytes(), name
    jw = jdur.WriteAheadLog(str(jdir / "wal.log"), fsync="off")
    pw = dur.WriteAheadLog(str(pdir / "wal.log"), fsync="off")
    for w, pack in ((jw, jdur._pack_arrays), (pw, dur._pack_arrays)):
        w.append(dur.REC_INSERT, pack(ops[0][1], ops[0][2]))
        w.append(dur.REC_DELETE, pack(np.arange(3, dtype=np.int64)))
        w.append(dur.REC_FP, fingerprint(p))
        w.close()
    assert (jdir / "wal.log").read_bytes() == (pdir / "wal.log").read_bytes()


@pytest.mark.parametrize("site", ["wal_torn_write", "wal_corrupt_record"])
def test_torn_tail_truncated_alike(tmp_path, jbase, ops, site):
    """A crash mid-append leaves a damaged tail; both packages read the
    same valid prefix, and the port's recovery truncates it and lands on
    the prefix of the writes before the crash."""
    p = port_of(jbase)
    fi = FaultInjector(seed=0, rates={})
    rt = ServingRuntime(p, _cfg(ServingConfig, wal_dir=str(tmp_path)),
                        faults=fi)
    serve_writes(rt, ops[:3])
    before = fingerprint(p)
    fi.rates[site] = 1.0
    with pytest.raises(InjectedFault):
        rt.submit_insert(ops[3][1], ops[3][2])
    rt.durability.closed = True      # the process is dead
    wal = str(tmp_path / dur.WAL_NAME)
    recs, valid, reason = dur.read_wal(wal)
    jrecs, jvalid, jreason = jdur.read_wal(wal)
    assert (valid, reason) == (jvalid, jreason)
    assert [(r.lsn, r.rtype, r.payload) for r in recs] == \
        [(r.lsn, r.rtype, r.payload) for r in jrecs]
    assert reason != "clean" and valid < os.path.getsize(wal)
    idx, rep = dur.recover_index(str(tmp_path), device="cpu")
    assert rep.wal_truncated_bytes > 0
    assert os.path.getsize(wal) == valid
    assert fingerprint(idx) == before
    assert rep.write_ops_recovered == 3


def test_damaged_generation_falls_back_alike(tmp_path, jbase, ops):
    """A damaged newest generation is rejected by both packages in favour
    of the older one, and both recover the same state from it."""
    p = port_of(jbase)
    root = str(tmp_path)
    m1, _ = dur.write_checkpoint(p, root, 1, wal_lsn=0, write_op_count=0)
    fp1 = fingerprint(p)
    for op in ops[:2]:
        p.insert(op[1], op[2])
    dur.write_checkpoint(p, root, 2, wal_lsn=0, write_op_count=2)
    gen2 = tmp_path / "ckpt-00000002"
    blob = sorted(n for n in os.listdir(gen2) if n.startswith("p"))[0]
    data = bytearray((gen2 / blob).read_bytes())
    data[len(data) // 2] ^= 0x01
    (gen2 / blob).write_bytes(bytes(data))
    path, man = dur.select_checkpoint(root)
    jpath, jman = jdur.select_checkpoint(root)
    assert path == jpath and path.endswith("ckpt-00000001")
    assert man == jman == m1
    idx, rep = dur.recover_index(root, device="cpu")
    jidx, jrep = jdur.recover_index(root)
    assert rep.generation == jrep.generation == 1
    assert fingerprint(idx) == jfingerprint(jidx) == fp1


def test_reference_injected_crash_recovered_by_port(tmp_path, jbase, ops):
    """The reverse of the torn-tail case: the JAX package's runtime
    crashes mid-append; the port recovers its directory."""
    j = copy.deepcopy(jbase)
    fi = JFaults(seed=0, rates={})
    rt = JRuntime(j, _cfg(JServingConfig, wal_dir=str(tmp_path)), faults=fi)
    serve_writes(rt, ops[:5])
    before = jfingerprint(j)
    fi.rates["wal_torn_write"] = 1.0
    with pytest.raises(JInjectedFault):
        rt.submit_insert(ops[6][1], ops[6][2])
    rt.durability.closed = True
    idx, rep = dur.recover_index(str(tmp_path), device="cpu")
    assert fingerprint(idx) == before
    assert rep.wal_truncated_bytes > 0 and rep.write_ops_recovered == 5
