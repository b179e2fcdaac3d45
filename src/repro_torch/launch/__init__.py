"""Entry points of the port: the LM server."""
