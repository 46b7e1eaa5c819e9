"""Data loaders of the port: the GNN seed-batch loader.

Unlike ``repro/data/__init__.py``, nothing token-related is pulled in."""
from repro_torch.data.graph_loader import SeedBatchLoader

__all__ = ["SeedBatchLoader"]
