"""Data loaders of the port: the GNN seed-batch loader and the synthetic
token stream.

Unlike ``repro/data/__init__.py``, nothing here loads jax: the token stream
is the port's own numpy copy, without the reference's dry-run specs."""
from repro_torch.data.graph_loader import SeedBatchLoader
from repro_torch.data.tokens import SyntheticTokenStream

__all__ = ["SeedBatchLoader", "SyntheticTokenStream"]
