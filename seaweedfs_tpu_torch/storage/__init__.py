"""Storage formats and lifecycles of the port."""
