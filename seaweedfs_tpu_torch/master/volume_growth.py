"""Volume growth: replica-placement-aware slot finding + volume creation.

Parity with weed/topology/volume_growth.go:106-230: pick a main data
center / rack / node plus the "other" nodes demanded by the replica
placement (DiffDataCenter / DiffRack / SameRack counts), weighting choices
by free slots, then allocate the volume on every chosen server.

The port's own copy of seaweedfs_tpu/master/volume_growth.py.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..storage.super_block import ReplicaPlacement
from ..storage.ttl import TTL
from .topology import DataCenter, DataNode, Rack, Topology

# grow this many logical volumes per growth request, by copy count
# (master_server.go:92-96 defaults)
GROWTH_COUNTS = {1: 7, 2: 6, 3: 3}
DEFAULT_GROWTH_COUNT = 1


@dataclass
class VolumeGrowOption:
    collection: str = ""
    replica_placement: ReplicaPlacement = field(
        default_factory=ReplicaPlacement)
    ttl: TTL = field(default_factory=TTL)
    preferred_data_center: str = ""
    preferred_rack: str = ""
    preferred_node: str = ""


def find_volume_count(copy_count: int) -> int:
    return GROWTH_COUNTS.get(copy_count, DEFAULT_GROWTH_COUNT)


def _pick_by_weight(candidates: list, count: int,
                    filter_fn: Callable) -> tuple[object, list]:
    """Pick `count` distinct nodes weighted by free slots; first is main.
    Raises ValueError when not enough candidates qualify."""
    qualified = []
    for c in candidates:
        try:
            filter_fn(c)
            qualified.append(c)
        except ValueError:
            continue
    if len(qualified) < count:
        raise ValueError(
            f"only {len(qualified)} of {len(candidates)} candidates "
            f"qualify, need {count}")
    picked = []
    pool = list(qualified)
    for _ in range(count):
        weights = [max(1, c.available_slots()) for c in pool]
        choice = random.choices(pool, weights=weights, k=1)[0]
        pool.remove(choice)
        picked.append(choice)
    return picked[0], picked[1:]


def find_empty_slots(topo: Topology, option: VolumeGrowOption
                     ) -> list[DataNode]:
    """The three-level placement search (findEmptySlotsForOneVolume)."""
    rp = option.replica_placement

    def dc_filter(dc: DataCenter):
        if (option.preferred_data_center
                and dc.id != option.preferred_data_center):
            raise ValueError("not preferred dc")
        if len(dc.racks) < rp.diff_rack + 1:
            raise ValueError("not enough racks")
        if dc.available_slots() < rp.diff_rack + rp.same_rack + 1:
            raise ValueError("not enough free slots in dc")
        racks_ok = sum(
            1 for rack in dc.racks.values()
            if sum(1 for n in rack.nodes.values()
                   if n.available_slots() >= 1) >= rp.same_rack + 1)
        if racks_ok < rp.diff_rack + 1:
            raise ValueError("not enough racks with free nodes")

    def rack_filter(rack: Rack):
        if option.preferred_rack and rack.id != option.preferred_rack:
            raise ValueError("not preferred rack")
        if rack.available_slots() < rp.same_rack + 1:
            raise ValueError("not enough free slots in rack")
        nodes_ok = sum(1 for n in rack.nodes.values()
                       if n.available_slots() >= 1)
        if nodes_ok < rp.same_rack + 1:
            raise ValueError("not enough free nodes in rack")

    def node_filter(node: DataNode):
        if option.preferred_node and node.id != option.preferred_node:
            raise ValueError("not preferred node")
        if node.available_slots() < 1:
            raise ValueError("node full")

    with topo.lock:
        main_dc, other_dcs = _pick_by_weight(
            list(topo.dcs.values()), rp.diff_dc + 1, dc_filter)
        main_rack, other_racks = _pick_by_weight(
            list(main_dc.racks.values()), rp.diff_rack + 1, rack_filter)
        main_node, other_nodes = _pick_by_weight(
            list(main_rack.nodes.values()), rp.same_rack + 1, node_filter)

        servers = [main_node] + other_nodes
        for rack in other_racks:
            node, _ = _pick_by_weight(list(rack.nodes.values()), 1,
                                      node_filter)
            servers.append(node)
        for dc in other_dcs:
            rack, _ = _pick_by_weight(list(dc.racks.values()), 1,
                                      rack_filter)
            node, _ = _pick_by_weight(list(rack.nodes.values()), 1,
                                      node_filter)
            servers.append(node)
        return servers


def grow_one_volume(topo: Topology, option: VolumeGrowOption,
                    allocate_fn: Callable[[DataNode, int], None]
                    ) -> tuple[int, list[DataNode]]:
    """Find placement, allocate a new vid, call allocate_fn per server.
    allocate_fn raises to abort (partial allocations are the caller's to
    clean up, as in the reference)."""
    servers = find_empty_slots(topo, option)
    vid = topo.next_volume_id()
    for server in servers:
        allocate_fn(server, vid)
    return vid, servers
