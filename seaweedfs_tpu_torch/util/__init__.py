"""Host utilities: platform probes."""
