"""Launchers of the port: `serve.py`, the token server, and `select.py`,
the SelectFormer workflow launcher."""
