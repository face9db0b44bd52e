"""Client-side helpers of the port: the bounded resource pool, the SigV4
S3 client and the volume server's TCP fast-path client.  The master
client and fid leases of the JAX package's wdclient come with the control
plane (ROADMAP item 8)."""
