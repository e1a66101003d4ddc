"""Geometric solvers: Sim3 and PnP RANSAC."""
