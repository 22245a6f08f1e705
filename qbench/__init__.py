"""The benchmark of ``repro_torch``, Quake's PyTorch and CUDA port.

Run one cell with ``python3 qbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the repository root (``BENCHMARK.json``
names the cells).  Everything a cell needs is found by name:

* ``configs/<config>.json``: the deployment (rows, width, index);
* ``traffic/<mix>.json``: the traffic mix, read by ``traffic.py``;
* ``metrics/<metric>.py``: one reader per per-layer metric;
* ``roofline/<kernel>.py``: what one kernel call needs, in bytes and FLOPs.

The harness imports the port (``repro_torch``) and nothing of the JAX
package ``repro`` or of ``jax``.
"""
