"""Minimum-spanning interconnection generation (paper §IV-B).

The reuse graph is directed (data flows from past to future), so the minimum
set of necessary connections is a minimum-cost *arborescence* rooted at the
virtual memory node.  We implement Chu-Liu/Edmonds with cycle contraction
(the paper cites Tarjan's variant [37]; LEGO grids are <= ~1k FUs so the
O(E·V) contraction algorithm is more than fast enough and exact).

The root's children become *data nodes* — FUs that fetch/commit data from/to
the memory system (they later drive the banking analysis, §IV-D).
"""

from __future__ import annotations

import numpy as np

__all__ = ["min_arborescence", "spanning_interconnect"]


def min_arborescence(
    n_nodes: int,
    root: int,
    edges: dict[tuple[int, int], float],
) -> dict[int, int]:
    """Chu-Liu/Edmonds: returns ``parent`` map (node -> chosen source) of the
    minimum-cost arborescence rooted at ``root`` covering all nodes.

    ``edges[(u, v)] = cost`` — multi-edges must be pre-reduced to min cost.
    Raises if some node is unreachable.
    """
    nodes = list(range(n_nodes + 1)) if root == n_nodes else list(range(n_nodes))
    nodes = sorted({root, *[u for u, _ in edges], *[v for _, v in edges],
                    *range(n_nodes)})

    def solve(node_ids: list[int], edge_list: list[tuple[int, int, float, int]], root_id: int):
        # edge_list entries: (u, v, cost, original_edge_id)
        # 1. cheapest incoming edge per node
        best: dict[int, tuple[int, float, int]] = {}
        for u, v, c, eid in edge_list:
            if v == root_id or u == v:
                continue
            if v not in best or c < best[v][1]:
                best[v] = (u, c, eid)
        for v in node_ids:
            if v != root_id and v not in best:
                raise ValueError(f"node {v} unreachable from root")

        # 2. detect cycles among chosen edges
        comp = {v: -1 for v in node_ids}
        comp_count = 0
        cycles: list[list[int]] = []
        state: dict[int, int] = {}
        for v in node_ids:
            if v == root_id or comp[v] != -1:
                continue
            path = []
            x = v
            while x != root_id and comp[x] == -1 and x not in state:
                state[x] = 1
                path.append(x)
                x = best[x][0]
            if x in state and state.get(x) == 1 and comp.get(x, 0) == -1 and x != root_id:
                # found a new cycle: nodes from x back to x
                cyc = path[path.index(x):]
                cycles.append(cyc)
            for p in path:
                state[p] = 2

        if not cycles:
            return {v: best[v][2] for v in node_ids if v != root_id}

        # 3. contract each cycle into a supernode
        cyc_id: dict[int, int] = {}
        for k, cyc in enumerate(cycles):
            for v in cyc:
                cyc_id[v] = k
        next_id = max(node_ids) + 1
        super_ids = [next_id + k for k in range(len(cycles))]
        new_nodes = [v for v in node_ids if v not in cyc_id] + super_ids

        def rep(v: int) -> int:
            return next_id + cyc_id[v] if v in cyc_id else v

        cyc_cost = {k: sum(best[v][1] for v in cyc) for k, cyc in enumerate(cycles)}
        new_edges: list[tuple[int, int, float, int]] = []
        # remember which original edge each contracted edge stands for, and
        # which cycle edge it displaces
        meta: dict[int, tuple[int, int | None]] = {}
        for ei, (u, v, c, eid) in enumerate(edge_list):
            ru, rv = rep(u), rep(v)
            if ru == rv:
                continue
            if v in cyc_id:
                # entering a cycle: adjusted cost = c - cost(cycle edge into v)
                adj = c - best[v][1]
                new_eid = len(meta) + 10_000_000
                meta[new_eid] = (eid, v)
                new_edges.append((ru, rv, adj, new_eid))
            else:
                new_eid = len(meta) + 10_000_000
                meta[new_eid] = (eid, None)
                new_edges.append((ru, rv, c, new_eid))

        sub = solve(new_nodes, new_edges, rep(root_id))

        # 4. expand
        chosen: dict[int, int] = {}
        entered: dict[int, int] = {}  # cycle k -> node whose cycle-edge is displaced
        for v, new_eid in sub.items():
            orig_eid, displaced = meta[new_eid]
            if displaced is not None:
                entered[cyc_id[displaced]] = displaced
            # map the edge back to its original head
            chosen[orig_eid] = orig_eid  # placeholder; resolve below
        # resolve original edges: rebuild from ids
        eid_to_edge = {eid: (u, v) for (u, v, c, eid) in edge_list}
        parent_edges: dict[int, int] = {}
        for v, new_eid in sub.items():
            orig_eid, _ = meta[new_eid]
            _, head = eid_to_edge[orig_eid]
            parent_edges[head] = orig_eid
        # cycle edges except the displaced one
        for k, cyc in enumerate(cycles):
            skip = entered.get(k)
            for v in cyc:
                if v == skip:
                    continue
                parent_edges[v] = best[v][2]
        return parent_edges

    edge_list = [(u, v, c, i) for i, ((u, v), c) in enumerate(edges.items())]
    eid_to_uv = {i: uv for i, (uv, _) in enumerate(edges.items())}
    chosen = solve(nodes, edge_list, root)
    return {v: eid_to_uv[eid][0] for v, eid in chosen.items()}


def spanning_interconnect(reuse_graph) -> tuple[dict[int, int], list[int]]:
    """Run Edmonds on a :class:`~repro_torch.core.interconnect.ReuseGraph`.

    Returns ``(parent, data_nodes)`` where ``parent[v]`` is the FU (or root)
    feeding FU ``v``, and ``data_nodes`` are the FUs fed by memory.
    """
    costs = {uv: c for uv, (c, _) in reuse_graph.edges.items()}
    parent = min_arborescence(reuse_graph.n_fus, reuse_graph.root, costs)
    data_nodes = sorted(v for v, p in parent.items() if p == reuse_graph.root)
    return parent, data_nodes
