"""The 16-joint window graph of HWGATE/WGATE (reference
`hwgat/models/model_params.py:261-369`), the 29-joint whole-body graph of
GATE (`model_params.py:21-56`) and the window → canonical-joint composition
of the data layout (`hwgat/dataTransform.py:426-455`)."""

from __future__ import annotations

import numpy as np

# 25 undirected edges over the 16 window joints [0-2 head | 3-5 arm | 6-15
# hand]; the four windows share this topology.
WINDOW_EDGES_16: tuple[tuple[int, int], ...] = (
    (0, 1), (0, 2), (0, 3), (3, 4), (4, 5), (5, 6),
    (6, 7), (6, 8), (8, 9), (8, 10), (6, 10), (10, 11), (10, 12), (6, 12),
    (12, 13), (12, 14), (14, 15), (6, 14), (7, 9), (9, 11), (11, 13),
    (13, 15), (7, 15), (7, 11), (7, 13),
)

# 34 undirected edges over the 29 canonical joints (22 body/left-hand edges +
# 12 right-hand edges written with the +10 offset in the reference).
BODY29_EDGES: tuple[tuple[int, int], ...] = (
    (2, 0), (1, 0), (0, 3), (0, 4), (3, 5), (4, 6), (5, 7), (6, 8), (7, 9),
    (9, 10), (9, 11), (11, 12), (11, 13), (13, 14), (9, 13), (13, 15), (9, 15),
    (15, 16), (15, 17), (9, 17), (17, 18), (8, 19),
    (19, 27), (19, 20), (19, 21), (19, 23), (19, 25),
    (21, 22), (21, 23), (23, 24), (23, 25), (25, 26), (25, 27), (27, 28),
)

# Which canonical joints (0..28) compose each of the 4 windows.
_HEAD = [0, 1, 2]
_L_ARM = [3, 5, 7]
_R_ARM = [4, 6, 8]
_L_HAND = list(range(9, 19))
_R_HAND = list(range(19, 29))
WINDOW_JOINTS: tuple[tuple[int, ...], ...] = (
    tuple(_HEAD + _L_ARM + _L_HAND),  # window 0: head + left arm + left hand
    tuple(_HEAD + _R_ARM + _R_HAND),  # window 1: head + right arm + right hand
    tuple(_HEAD + _L_ARM + _R_HAND),  # window 2: head + left arm + right hand
    tuple(_HEAD + _R_ARM + _L_HAND),  # window 3: head + right arm + left hand
)


def edges_to_dense(edges, num_nodes: int, self_loops: bool = True,
                   dtype=np.float32) -> np.ndarray:
    """Symmetric {0,1} dense adjacency from an undirected edge list."""
    a = np.eye(num_nodes, dtype=dtype) if self_loops else np.zeros((num_nodes, num_nodes), dtype=dtype)
    for i, j in edges:
        a[i, j] = 1
        a[j, i] = 1
    return a
