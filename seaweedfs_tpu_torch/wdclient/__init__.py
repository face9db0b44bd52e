"""Client-side helpers of the port: the master client with its batched
fid leases, the bounded resource pool, the SigV4 S3 client and the
volume server's TCP fast-path client."""

from .fid_lease import FidLeaseCache
from .masterclient import MasterClient, VidMap

__all__ = ["FidLeaseCache", "MasterClient", "VidMap"]
