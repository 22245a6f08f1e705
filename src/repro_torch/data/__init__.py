"""Synthetic datasets (numpy, made from a seed) and the recsys batch
pipeline."""
from .pipelines import RecsysPipeline

__all__ = ["RecsysPipeline"]
