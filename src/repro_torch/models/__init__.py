"""Model definitions: the GNN family and the transformer backbone."""
