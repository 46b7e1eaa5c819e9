from repro_torch.graph.graph import HeteroGraph, GraphPartition, build_partitions
from repro_torch.graph.generate import power_law_graph, named_dataset
from repro_torch.graph.metrics import partition_metrics, replication_factor, edge_balance, vertex_balance
from repro_torch.graph.reorder import reorder_permutation, REORDER_ALGS

__all__ = [
    "HeteroGraph",
    "GraphPartition",
    "build_partitions",
    "power_law_graph",
    "named_dataset",
    "partition_metrics",
    "replication_factor",
    "edge_balance",
    "vertex_balance",
    "reorder_permutation",
    "REORDER_ALGS",
]
