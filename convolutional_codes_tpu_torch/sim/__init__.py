"""Simulation chains, the sweep runner and the CLI."""
