"""Launchers: the transformer side's shapes and step functions
(``specs``) and serving entry point (``serve``), and the GNN training
launcher (``train``)."""
