import numpy as np
import pytest


@pytest.fixture(scope="session")
def small_graph():
    from repro.graph import power_law_graph

    return power_law_graph(2000, avg_degree=8, seed=7, feat_dim=16, num_classes=4)


@pytest.fixture(scope="session")
def partitioned(small_graph):
    from repro.core.partition import adadne
    from repro.graph import build_partitions

    ep = adadne(small_graph, 4, seed=0)
    parts = build_partitions(small_graph, ep, 4)
    return ep, parts


@pytest.fixture(scope="session")
def sampling_client(small_graph, partitioned):
    from repro.core.sampling import GatherApplyClient, SamplingServer, VertexRouter

    ep, parts = partitioned
    return GatherApplyClient(
        [SamplingServer(p, seed=0) for p in parts],
        VertexRouter(small_graph, ep, 4),
        seed=0,
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one); run with -m gpu"
    )
