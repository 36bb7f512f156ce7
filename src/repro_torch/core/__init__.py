"""Core pipeline stages of the port (paper §2.4), one module per stage."""
