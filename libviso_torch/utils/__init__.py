"""Trajectory metrics and per-frame logging."""
