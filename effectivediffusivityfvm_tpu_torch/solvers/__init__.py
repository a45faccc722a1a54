"""Solvers (torch)."""
