"""Model definitions (the GNN family)."""
