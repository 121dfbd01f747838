"""Graph-level optimizer: rewrites + PET/EinNet-style search (see
search.py); counterpart of infinitensor_tpu/optimizer."""

from infinitensor_tpu_torch.optimizer.rewrite import optimize_graph

__all__ = ["optimize_graph"]
