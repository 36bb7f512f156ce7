"""Models of the port: the dense decoder-only LM and its attention
backends (the reference's other families wait for ROADMAP A13)."""
