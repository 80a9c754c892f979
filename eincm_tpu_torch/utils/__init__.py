"""Shared workloads."""
