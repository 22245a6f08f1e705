"""The JAX package's four examples (``examples/*.py``) as entry points of
the port, each runnable with ``python -m repro_torch.examples.<name>
[--device cpu]`` (on the card by default):

  * ``quickstart``: build, per-query APS search, a skewed insert burst,
    cost-model maintenance, recall again;
  * ``dynamic_workload``: a static IVF baseline against Quake over the
    Wikipedia-style workload, month by month (paper Fig. 4);
  * ``retrieval_serving``: two-tower candidate retrieval through brute
    force, the index and the sharded engine (f32 and int8);
  * ``train_lm``: LM training (``launch.train``) on its quick preset.

Each has a ``run(...)`` with the reference's sizes as defaults that
prints the reference's lines and returns their numbers as a dict.
"""
