"""Maintenance jobs: deep scrub."""
