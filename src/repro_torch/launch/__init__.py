"""Launchers of the transformer side: shapes and step functions
(``specs``), and the serving entry point (``serve``)."""
