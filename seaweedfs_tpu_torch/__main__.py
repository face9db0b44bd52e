"""`python -m seaweedfs_tpu_torch <cmd>`: the port's command line
(seaweedfs_tpu_torch/weed.py)."""

from .weed import main

if __name__ == "__main__":
    main()
