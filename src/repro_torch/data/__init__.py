"""Synthetic datasets (numpy, made from a seed), the graph generators and
neighbour sampler (``graphs``), and the token, recsys and graph
minibatch pipelines."""
from .pipelines import GraphMinibatchPipeline, RecsysPipeline, TokenPipeline

__all__ = ["GraphMinibatchPipeline", "RecsysPipeline", "TokenPipeline"]
