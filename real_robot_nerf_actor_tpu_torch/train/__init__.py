"""Configs and the deployment loop (`serve.py`)."""
