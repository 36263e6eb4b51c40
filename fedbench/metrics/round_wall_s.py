"""Seconds a round, read as ``round_s`` reads it, for a cell whose rounds
vary too much from run to run to hold that end to end."""
from .round_s import read  # noqa: F401
