"""ST-GCN partition-strategy adjacency stacks, the port's own copy of
``sl_hwgat_tpu/graphs/partition.py`` (numpy only).

Reproduces the reference `hwgat/models/graph_utils.py:4-150` semantics:
hop-distance computation, in-degree normalization, and the three partition
strategies (uniform / distance / spatial) from the ST-GCN paper, plus the
equal-weight spatial stack used by DecoupledGCN.
"""

from __future__ import annotations

import numpy as np


def hop_distance(num_nodes: int, edges, max_hop: int = 1) -> np.ndarray:
    """Per-pair hop distance, inf beyond ``max_hop``. ≡ `graph_utils.py:4-17`."""
    a = np.zeros((num_nodes, num_nodes))
    for i, j in edges:
        a[i, j] = 1
        a[j, i] = 1
    dist = np.full((num_nodes, num_nodes), np.inf)
    powers = [np.linalg.matrix_power(a, d) for d in range(max_hop + 1)]
    arrive = np.stack(powers) > 0
    for d in range(max_hop, -1, -1):
        dist[arrive[d]] = d
    return dist


def normalize_digraph(a: np.ndarray) -> np.ndarray:
    """Column-degree normalization A @ D^-1. ≡ `graph_utils.py:20-28`."""
    deg = a.sum(axis=0)
    dn = np.zeros_like(a)
    nz = deg > 0
    dn[nz, nz] = deg[nz] ** -1
    return a @ dn


def edge2mat(links, num_nodes: int) -> np.ndarray:
    """Directed link list → adjacency with A[j, i] = 1. ≡ `graph_utils.py:31-35`."""
    a = np.zeros((num_nodes, num_nodes))
    for i, j in links:
        a[j, i] = 1
    return a


def spatial_graph(num_nodes: int, inward_edges) -> np.ndarray:
    """(3, V, V) [I | normalized inward | normalized outward] stack.

    ≡ `graph_utils.py:37-42` + `SpatialGraph` (`:129-150`); consumed by
    DecoupledGCN.
    """
    self_link = [(i, i) for i in range(num_nodes)]
    outward = [(j, i) for (i, j) in inward_edges]
    return np.stack(
        [
            edge2mat(self_link, num_nodes),
            normalize_digraph(edge2mat(inward_edges, num_nodes)),
            normalize_digraph(edge2mat(outward, num_nodes)),
        ]
    )


class GraphPartition:
    """Partitioned skeleton adjacency for ST-GCN. ≡ `graph_utils.py:44-127`.

    Produces ``A`` of shape (K_part, V, V); strategy ∈ {uniform, distance,
    spatial}.
    """

    def __init__(self, num_nodes: int, center: int, inward_edges,
                 strategy: str = "spatial", max_hop: int = 1, dilation: int = 1):
        self.num_nodes = num_nodes
        self.center = center
        self.edges = [[i, i] for i in range(num_nodes)] + [list(e) for e in inward_edges]
        self.max_hop = max_hop
        self.dilation = dilation
        self.hop_dis = hop_distance(num_nodes, self.edges, max_hop=max_hop)
        self.A = self._build(strategy)

    def _build(self, strategy: str) -> np.ndarray:
        valid_hop = range(0, self.max_hop + 1, self.dilation)
        adjacency = np.zeros((self.num_nodes, self.num_nodes))
        for hop in valid_hop:
            adjacency[self.hop_dis == hop] = 1
        norm_adj = normalize_digraph(adjacency)

        if strategy == "uniform":
            return norm_adj[None]
        if strategy == "distance":
            a = np.zeros((len(valid_hop), self.num_nodes, self.num_nodes))
            for i, hop in enumerate(valid_hop):
                a[i][self.hop_dis == hop] = norm_adj[self.hop_dis == hop]
            return a
        if strategy == "spatial":
            out = []
            for hop in valid_hop:
                a_root = np.zeros((self.num_nodes, self.num_nodes))
                a_close = np.zeros((self.num_nodes, self.num_nodes))
                a_further = np.zeros((self.num_nodes, self.num_nodes))
                for i in range(self.num_nodes):
                    for j in range(self.num_nodes):
                        if self.hop_dis[j, i] != hop:
                            continue
                        if self.hop_dis[j, self.center] == self.hop_dis[i, self.center]:
                            a_root[j, i] = norm_adj[j, i]
                        elif self.hop_dis[j, self.center] > self.hop_dis[i, self.center]:
                            a_close[j, i] = norm_adj[j, i]
                        else:
                            a_further[j, i] = norm_adj[j, i]
                if hop == 0:
                    out.append(a_root)
                else:
                    out.append(a_root + a_close)
                    out.append(a_further)
            return np.stack(out)
        raise ValueError(f"unknown partition strategy: {strategy}")
