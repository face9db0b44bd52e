"""Host utilities: platform probes and fault injection."""
