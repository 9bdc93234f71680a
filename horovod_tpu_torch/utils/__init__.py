"""Utilities of the port: rank-coordinated checkpoints (``checkpoint``)."""
