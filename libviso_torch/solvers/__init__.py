"""Gauss-Newton pose refinement and batched RANSAC."""
