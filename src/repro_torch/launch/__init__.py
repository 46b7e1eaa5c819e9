"""Launchers: the transformer side's shapes and step functions
(``specs``) and serving entry point (``serve``), the GNN training launcher
(``train``), the H100's roofline (``roofline``): the model-FLOPs and
byte accounting behind every kernel bound and every step's share of the
card's peaks, and the production-mesh dry run (``dryrun``, with the
meshes of ``mesh`` and the sharding rules of ``shardings``)."""
