"""Batched device steps and the streaming EC pipeline."""
