"""Model configurations, as plain data: the LM architectures
(``lm_archs``), the recsys architectures with their serving and training
shapes (``recsys_archs``), the GAT with its graph shapes (``gnn_archs``)
and the training cells' optimizer and LM shapes (``training``)."""
from . import gnn_archs, lm_archs, recsys_archs, training

__all__ = ["gnn_archs", "lm_archs", "recsys_archs", "training"]
