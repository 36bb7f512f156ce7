"""Optimizers of the port (``optimizers``)."""
