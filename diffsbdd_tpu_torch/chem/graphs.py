"""The graph algorithms that molecule descriptors need, without networkx.

Ring perception must give the very rings that networkx 3.6.1 gives: the
descriptors read ring atom sets (aromatic rings, spiro and bridge counts,
rotatable bonds), and a different but equally minimal cycle basis would change
them.  So ``minimum_cycle_basis`` is networkx's own algorithm (de Pina's
method, ``networkx/algorithms/cycles.py``) with its data structures and
iteration orders: a graph is networkx's adjacency, a dict of dicts in
insertion order; the chords are a Python ``set`` of ``(u, v)`` tuples built
by the same set expressions; the shortest paths on the lifted graph break
ties as networkx's Dijkstra does.  ``cycle_basis`` and
``connected_components`` follow networkx in the same way.

Adapted from NetworkX 3.6.1 (https://networkx.org), which is distributed
under the 3-clause BSD licence: Copyright (C) 2004-2025, NetworkX
Developers, Aric Hagberg, Dan Schult, Pieter Swart.  All rights reserved.
Redistribution and use in source and binary forms, with or without
modification, are permitted provided that the conditions of that licence
are met.
"""
from __future__ import annotations

from heapq import heappop, heappush
from itertools import count
from typing import Dict, Hashable, Iterable, Iterator, List, Set, Tuple

Adjacency = Dict[Hashable, Dict[Hashable, None]]


def graph(n_nodes: int, edges: Iterable[Tuple[int, int]]) -> Adjacency:
    """The adjacency networkx builds from ``add_nodes_from(range(n_nodes))``
    and then ``add_edges_from(edges)``."""
    adj: Adjacency = {v: {} for v in range(n_nodes)}
    for u, v in edges:
        _add_edge(adj, u, v)
    return adj


def _add_edge(adj: Adjacency, u, v) -> None:
    """networkx's ``Graph.add_edge``: new nodes are appended, an edge that is
    there already keeps its place."""
    adj.setdefault(u, {})
    adj.setdefault(v, {})
    adj[u][v] = None
    adj[v][u] = None


def _edges(adj: Adjacency) -> Iterator[Tuple]:
    """networkx's ``EdgeView`` order: each edge once, from the node met
    first."""
    seen = {}
    for n, nbrs in adj.items():
        for nbr in list(nbrs):
            if nbr not in seen:
                yield (n, nbr)
        seen[n] = 1


def _plain_bfs(adj: Adjacency, n: int, source) -> Set:
    seen = {source}
    nextlevel = [source]
    while nextlevel:
        thislevel = nextlevel
        nextlevel = []
        for v in thislevel:
            for w in adj[v]:
                if w not in seen:
                    seen.add(w)
                    nextlevel.append(w)
            if len(seen) == n:
                return seen
    return seen


def connected_components(adj: Adjacency) -> Iterator[Set]:
    """The node sets of the components, in networkx's order."""
    seen: Set = set()
    n = len(adj)
    for v in adj:
        if v not in seen:
            c = _plain_bfs(adj, n - len(seen), v)
            seen.update(c)
            yield c


def _subgraph(adj: Adjacency, nodes: Iterable) -> Adjacency:
    """The adjacency of networkx's ``G.subgraph(nodes)`` view, with its node
    order: the node set's own order when it holds fewer than half of G's
    nodes, else G's."""
    keep = set(n for n in nodes if n in adj)
    if 2 * len(keep) < len(adj):
        order = [n for n in keep if n in adj]
    else:
        order = [n for n in adj if n in keep]
    return {n: {nbr: None for nbr in adj[n] if nbr in keep} for n in order}


def _bfs(adj: Adjacency, source) -> Dict:
    """Shortest-path lengths (edges) from ``source`` to every node it
    reaches."""
    dist = {source: 0}
    level = [source]
    while level:
        nxt = []
        for v in level:
            for w in adj[v]:
                if w not in dist:
                    dist[w] = dist[v] + 1
                    nxt.append(w)
        level = nxt
    return dist


def longest_shortest_path(adj: Adjacency, nodes: Iterable) -> int:
    """The largest shortest-path length (edges) between two nodes of the
    connected node set ``nodes``: a breadth-first search from each node, the
    value of networkx's ``all_pairs_shortest_path_length`` on the subgraph."""
    sub = _subgraph(adj, nodes)
    return max(max(_bfs(sub, source).values()) for source in sub)


def cycle_basis(adj: Adjacency) -> List[List]:
    """networkx's ``cycle_basis``: a depth-first spanning tree from the last
    node of each component, one cycle for each edge that closes one."""
    gnodes = dict.fromkeys(adj)
    cycles = []
    root = None
    while gnodes:
        if root is None:
            root = gnodes.popitem()[0]
        stack = [root]
        pred = {root: root}
        used = {root: set()}
        while stack:
            z = stack.pop()
            zused = used[z]
            for nbr in adj[z]:
                if nbr not in used:
                    pred[nbr] = z
                    stack.append(nbr)
                    used[nbr] = {z}
                elif nbr == z:
                    cycles.append([z])
                elif nbr not in zused:
                    pn = used[nbr]
                    cycle = [nbr, z]
                    p = pred[z]
                    while p not in pn:
                        cycle.append(p)
                        p = pred[p]
                    cycle.append(p)
                    cycles.append(cycle)
                    used[nbr].add(z)
        for node in pred:
            gnodes.pop(node, None)
        root = None
    return cycles


def minimum_cycle_basis(adj: Adjacency) -> List[List]:
    """networkx's ``minimum_cycle_basis`` (unweighted): the bases of the
    components, in component order."""
    return sum((_min_cycle_basis(_subgraph(adj, c))
                for c in connected_components(adj)), [])


def _spanning_edges(adj: Adjacency) -> List[Tuple]:
    """Kruskal with every weight 1: the edges in ``EdgeView`` order (a stable
    sort keeps it) that join two trees."""
    parent: Dict = {}

    def find(a):
        parent.setdefault(a, a)
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    tree = []
    for u, v in _edges(adj):
        ru, rv = find(u), find(v)
        if ru != rv:
            tree.append((u, v))
            parent[ru] = rv
    return tree


def _min_cycle_basis(adj: Adjacency) -> List[List]:
    cb = []
    tree_edges = _spanning_edges(adj)
    # ``G.edges - tree_edges`` of networkx: a set built from the edges in
    # EdgeView order, then a set difference -- the iteration order of
    # ``chords`` below is that of these very set operations
    other = set(tree_edges)
    chords = set(e for e in _edges(adj) if e not in other) \
        - {(v, u) for u, v in tree_edges}

    set_orth = [{edge} for edge in chords]
    while set_orth:
        base = set_orth.pop()
        cycle_edges = _min_cycle(adj, base)
        cb.append([v for u, v in cycle_edges])
        set_orth = [
            (
                {e for e in orth if e not in base if e[::-1] not in base}
                | {e for e in base if e not in orth if e[::-1] not in orth}
            )
            if sum((e in orth or e[::-1] in orth) for e in cycle_edges) % 2
            else orth
            for orth in set_orth
        ]
    return cb


def _bidirectional_dijkstra(adj: Adjacency, source, target) -> List:
    """networkx's ``bidirectional_dijkstra`` with unit weights, the route
    ``nx.shortest_path`` takes from a source to a target: the two searches
    alternate, and ties break by push order."""
    dists: List[Dict] = [{}, {}]
    preds: List[Dict] = [{source: None}, {target: None}]

    def path(curr, direction):
        ret = []
        while curr is not None:
            ret.append(curr)
            curr = preds[direction][curr]
        return list(reversed(ret)) if direction == 0 else ret

    fringe: List[List] = [[], []]
    seen: List[Dict] = [{source: 0}, {target: 0}]
    c = count()
    heappush(fringe[0], (0, next(c), source))
    heappush(fringe[1], (0, next(c), target))
    finaldist = None
    meetnode = None
    direction = 1
    while fringe[0] and fringe[1]:
        direction = 1 - direction
        dist, _, v = heappop(fringe[direction])
        if v in dists[direction]:
            continue
        dists[direction][v] = dist
        if v in dists[1 - direction]:
            return path(meetnode, 0) + path(preds[1][meetnode], 1)
        for w in adj[v]:
            vw_length = dist + 1
            if w in dists[direction]:
                continue
            if w not in seen[direction] or vw_length < seen[direction][w]:
                seen[direction][w] = vw_length
                heappush(fringe[direction], (vw_length, next(c), w))
                preds[direction][w] = v
                if w in seen[1 - direction]:
                    finaldist_w = vw_length + seen[1 - direction][w]
                    if finaldist is None or finaldist > finaldist_w:
                        finaldist, meetnode = finaldist_w, w
    raise ValueError(f"no path between {source} and {target}")


def _min_cycle(adj: Adjacency, orth: Set) -> List[Tuple]:
    """The shortest cycle with an odd number of edges in ``orth``: the
    shortest path from a node to its lifted copy ``(n, 1)`` in the graph
    where the edges of ``orth`` cross between the two copies."""
    lifted: Adjacency = {}
    for u, v in _edges(adj):
        if (u, v) in orth or (v, u) in orth:
            _add_edge(lifted, u, (v, 1))
            _add_edge(lifted, (u, 1), v)
        else:
            _add_edge(lifted, u, v)
            _add_edge(lifted, (u, 1), (v, 1))

    lift = {n: _bfs(lifted, n)[(n, 1)] for n in adj}
    start = min(lift, key=lift.get)
    path = _bidirectional_dijkstra(lifted, start, (start, 1))

    min_path = [n if n in adj else n[0] for n in path]
    edgelist = list(zip(min_path, min_path[1:]))
    edgeset: Set = set()
    for e in edgelist:
        if e in edgeset:
            edgeset.remove(e)
        elif e[::-1] in edgeset:
            edgeset.remove(e[::-1])
        else:
            edgeset.add(e)

    min_edgelist = []
    for e in edgelist:
        if e in edgeset:
            min_edgelist.append(e)
            edgeset.remove(e)
        elif e[::-1] in edgeset:
            min_edgelist.append(e[::-1])
            edgeset.remove(e[::-1])
    return min_edgelist
