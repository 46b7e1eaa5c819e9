from repro_torch.models.gnn.models import GNN_KINDS, GNNModel, load_jax_params

__all__ = ["GNN_KINDS", "GNNModel", "load_jax_params"]
