"""Model configurations, as plain data: the LM architectures
(``lm_archs``), the recsys architectures with their serving shapes
(``recsys_archs``) and the GAT with its graph shapes (``gnn_archs``)."""
from . import gnn_archs, lm_archs, recsys_archs

__all__ = ["gnn_archs", "lm_archs", "recsys_archs"]
