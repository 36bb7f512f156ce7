"""Serving loop of the port (``serve_loop.Engine``)."""
