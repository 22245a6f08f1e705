"""Synthetic datasets (numpy, made from a seed), the graph generators and
neighbour sampler (``graphs``), and the recsys and graph minibatch
pipelines."""
from .pipelines import GraphMinibatchPipeline, RecsysPipeline

__all__ = ["GraphMinibatchPipeline", "RecsysPipeline"]
