"""Synthetic shortest-path task on a random directed graph (a copy of the
JAX package's examples/randomwalks/randomwalks.py, numpy only, so the
port imports nothing of the JAX side).

Nodes are letters; the model continues a walk from a start node to the
goal node 'a' in as few steps as possible, and `metric_fn` scores
optimality in [0, 1] against the true shortest path (a plain BFS). With
the byte tokenizer one letter is one token.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


def _bfs_shortest_lengths(adj: np.ndarray, goal: int, max_length: int) -> List[int]:
    """Shortest path length (in nodes, incl. endpoints, capped) from every
    non-goal node to `goal` over directed edges."""
    n = adj.shape[0]
    out = []
    for start in range(n):
        if start == goal:
            continue
        frontier = {start}
        seen = {start}
        dist = None
        for depth in range(1, max_length + 1):
            if goal in frontier:
                dist = depth
                break
            nxt = set()
            for u in frontier:
                nxt.update(np.nonzero(adj[u])[0].tolist())
            frontier = nxt - seen
            seen |= frontier
            if not frontier:
                break
        out.append(dist if dist is not None else max_length)
    return out


def generate_random_walks(
    n_nodes: int = 21,
    max_length: int = 10,
    n_walks: int = 1000,
    p_edge: float = 0.1,
    seed: int = 1002,
) -> Tuple[Callable, List[str], List[str], np.ndarray]:
    """Returns (metric_fn, eval_prompts, sample_walks, adjacency_matrix)."""
    rng = np.random.RandomState(seed)

    while True:
        adj = rng.rand(n_nodes, n_nodes) > (1 - p_edge)
        np.fill_diagonal(adj, 0)
        if np.all(adj.sum(1)):  # every node has at least one outgoing edge
            break

    goal = 0
    adj[goal, :] = 0
    adj[goal, goal] = 1

    node_to_char = {ix: chr(ix + ord("a")) for ix in range(n_nodes)}
    char_to_node = {c: n for n, c in node_to_char.items()}

    sample_walks: List[str] = []
    for _ in range(n_walks):
        node = rng.randint(1, n_nodes)  # any non-goal start
        walk = [node]
        for _step in range(max_length - 1):
            node = rng.choice(np.nonzero(adj[node])[0])
            walk.append(node)
            if node == goal:
                break
        sample_walks.append("".join(node_to_char[ix] for ix in walk))

    shortest_lengths = _bfs_shortest_lengths(adj, goal, max_length)

    def metric_fn(samples: List[str], **kwargs) -> Dict[str, List[float]]:
        invalid_path_length = 100
        lengths: List[float] = []
        optimal: List[int] = []
        for sample_str in samples:
            nodes = [char_to_node.get(c, 1000) for c in sample_str.strip()]
            length: Optional[float] = None
            for i, node in enumerate(nodes):
                if node >= n_nodes or (i > 0 and not adj[nodes[i - 1], node]):
                    length = invalid_path_length
                    break
                if node == goal:
                    length = i + 1
                    break
            if length is None:
                length = invalid_path_length
            lengths.append(float(length))
            start = nodes[0] if nodes and nodes[0] < n_nodes else 1
            optimal.append(shortest_lengths[start - 1])

        lengths_arr = np.asarray(lengths, np.float32)
        bound = np.where(lengths_arr == invalid_path_length, max_length, lengths_arr)
        optimality = (max_length - bound) / (
            max_length - np.asarray(optimal, np.float32)
        )
        return {"lengths": lengths, "optimality": optimality.tolist()}

    eval_prompts = sorted(set(w[0] for w in sample_walks))
    return metric_fn, eval_prompts, sample_walks, adj
