"""Partitioning, sampling, tiered storage and the layerwise inference engine."""
