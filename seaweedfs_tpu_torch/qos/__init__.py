"""Quality of service: the device lanes that let degraded reads preempt
background device work."""
