from .metrics import Counter, Gauge, Histogram, Registry, REGISTRY

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY"]
