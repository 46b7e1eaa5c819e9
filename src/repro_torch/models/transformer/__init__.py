"""The transformer backbone (dense and SSM families) of the port."""
