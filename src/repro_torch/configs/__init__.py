"""Model configurations, as plain data: the LM architectures
(``lm_archs``) and the recsys architectures with their serving shapes
(``recsys_archs``)."""
from . import lm_archs, recsys_archs

__all__ = ["lm_archs", "recsys_archs"]
