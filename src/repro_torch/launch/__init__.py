"""Launchers of the port: `serve.py`, the token server, `select.py`, the
SelectFormer workflow launcher, and `train.py`, the model zoo's training
driver."""
