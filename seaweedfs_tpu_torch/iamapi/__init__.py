"""The port's own copy of seaweedfs_tpu/iamapi/__init__.py."""
from .server import IamApiServer  # noqa: F401
