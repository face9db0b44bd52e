"""The port's own copy of seaweedfs_tpu/s3api/__init__.py."""
