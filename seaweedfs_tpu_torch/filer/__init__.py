"""The filer's directory-prefix shard map, which the master's raft
snapshots carry (master/fsm.py).  The rest of the JAX package's filer
(store, server, path config) comes with ROADMAP item 9."""
