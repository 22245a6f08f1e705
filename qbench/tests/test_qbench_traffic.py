"""The traffic and the data repeat exactly for a seed."""
import numpy as np
import pytest
import torch

from qbench import data as qdata
from qbench import spec, traffic

DEV = torch.device("cpu")
SMALL = {"rows": 3000, "dim": 16,
         "data": {"clusters": 32, "query_jitter": 0.1}}


def _cfg(name):
    return spec.load_cell(name, overrides={"config": SMALL}).config


def test_base_table_is_the_configurations():
    cfg = _cfg("sift1m-l2.aps-b1024")
    a = qdata.base_rows(cfg, qdata.from_config(cfg, DEV), DEV)[0]
    b = qdata.base_rows(cfg, qdata.from_config(cfg, DEV), DEV)[0]
    assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 2**31 + 17, 2**40 + 3])
def test_batch_pool_repeats_for_a_seed(seed):
    cfg = _cfg("sift1m-l2.aps-b1024")
    x, _ = qdata.base_rows(cfg, qdata.from_config(cfg, DEV), DEV)
    tr = {"batch": 8, "pool_batches": 3, "warm_batches": 1}
    a = traffic.batch_work(tr, cfg, x, seed).pool
    b = traffic.batch_work(tr, cfg, x, seed).pool
    c = traffic.batch_work(tr, cfg, x, seed + 1).pool
    assert a.shape == (3, 8, 16)
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_batches_in_the_pool_are_fresh():
    """Every batch of a pool holds queries of its own: a window sends no
    batch twice until the pool is spent."""
    cfg = _cfg("sift1m-l2.aps-b1024")
    x, _ = qdata.base_rows(cfg, qdata.from_config(cfg, DEV), DEV)
    tr = {"batch": 8, "pool_batches": 20, "warm_batches": 1}
    pool = traffic.batch_work(tr, cfg, x, 2**33 + 1).pool
    flat = pool.reshape(20, -1)
    assert len(np.unique(flat, axis=0)) == 20


@pytest.mark.parametrize("cell", ["sift1m-l2.aps-b1024",
                                  "sift1m-l2.nprobe32-b1024"])
def test_mix_pool_outlasts_the_measured_window(cell):
    """A mix's pool holds more batches than its cell's window sent on the
    card (5,527 and 40,600 queries/s at most over 51 s): the window
    sends fresh queries only."""
    most = {"sift1m-l2.aps-b1024": 5527.0,
            "sift1m-l2.nprobe32-b1024": 40600.0}[cell]
    c = spec.load_cell(cell)
    sent = most * spec.load_benchmark()["run_seconds"] / c.traffic["batch"]
    assert c.traffic["pool_batches"] >= 1.2 * sent
