"""Trajectory IO and evaluation (numpy)."""
