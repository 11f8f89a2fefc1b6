"""Launchers of the port: `serve.py`, the token server."""
