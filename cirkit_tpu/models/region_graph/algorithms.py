"""Region graph construction algorithms.

Rebuild of ``cirkit/templates/region_graph/algorithms/``: FullyFactorized,
LinearTree, RandomBinaryTree, QuadTree/QuadGraph, PoonDomingos and
ChowLiuTree (numpy-native; the reference uses torch for the MI matrix).
"""

from __future__ import annotations

import itertools
from collections import defaultdict, deque
from collections.abc import Sequence

import numpy as np
from scipy import sparse as sp

from cirkit_tpu.models.region_graph.graph import (
    PartitionNode,
    RegionGraph,
    RegionGraphNode,
    RegionNode,
)
from cirkit_tpu.utils.scope import Scope

HyperCube = tuple[tuple[int, ...], tuple[int, ...]]
"""A hypercube given by its "top-left" and "bottom-right" corner coordinates."""


class HypercubeToScope(dict):
    """A caching map from sub-hypercubes of a (C, H, W) variable layout to
    flat variable scopes.

    The dict-with-``__missing__`` memoization pattern and the slice-then-
    flatten scope math follow the reference's host-side utility
    (``cirkit/templates/region_graph/algorithms/utils.py:18-66``) — a
    ~20-line pure-numpy helper with essentially one natural formulation,
    reimplemented here for parity."""

    def __init__(self, shape: tuple[int, ...]) -> None:
        super().__init__()
        self.ndims = len(shape)
        self.shape = tuple(shape)
        self.hypercube = np.arange(int(np.prod(shape)), dtype=np.int64).reshape(shape)

    def __missing__(self, key: HyperCube) -> Scope:
        point1, point2 = key
        if not len(point1) == len(point2) == self.ndims:
            raise ValueError("The dimension of the hypercube is not correct")
        if not all(0 <= a < b <= s for a, b, s in zip(point1, point2, self.shape)):
            raise ValueError("The hypercube is empty")
        block = self.hypercube[tuple(slice(a, b) for a, b in zip(point1, point2))]
        scope = Scope(block.reshape(-1).tolist())
        self[key] = scope
        return scope


# pylint: disable-next=invalid-name
def FullyFactorized(num_variables: int, *, num_repetitions: int = 1) -> RegionGraph:
    """A region graph with fully-factorized partitions."""
    if num_variables <= 0:
        raise ValueError("The number of variables must be positive")
    if num_repetitions <= 0:
        raise ValueError("The number of repetitions must be positive")
    root = RegionNode(range(num_variables))
    nodes: list[RegionGraphNode] = [root]
    in_nodes: dict[RegionGraphNode, list[RegionGraphNode]] = {root: []}
    if num_variables == 1:
        return RegionGraph(nodes, in_nodes, [root])
    for _ in range(num_repetitions):
        ptn = PartitionNode(range(num_variables))
        leaves: list[RegionGraphNode] = [RegionNode([v]) for v in range(num_variables)]
        nodes.extend(leaves)
        nodes.append(ptn)
        in_nodes[ptn] = leaves
        in_nodes[root].append(ptn)
    return RegionGraph(nodes, in_nodes, [root])


# pylint: disable-next=invalid-name
def LinearTree(
    num_variables: int,
    *,
    num_repetitions: int = 1,
    ordering: list[int] | None = None,
    randomize: bool = False,
    seed: int = 42,
) -> RegionGraph:
    """A linear-tree region graph: each partition peels one variable off."""
    if num_variables <= 0:
        raise ValueError("The number of variables must be positive")
    if num_repetitions <= 0:
        raise ValueError("The number of repetitions must be positive")
    if ordering is not None and sorted(ordering) != list(range(num_variables)):
        raise ValueError("The ordering must be a permutation of range(num_variables)")
    root = RegionNode(range(num_variables))
    nodes: list[RegionGraphNode] = [root]
    in_nodes: dict[RegionGraphNode, list[RegionGraphNode]] = defaultdict(list)
    if num_variables == 1:
        return RegionGraph(nodes, dict(in_nodes), [root])
    if ordering is None:
        ordering = list(range(num_variables))
    rng = np.random.RandomState(seed) if randomize else None
    for _ in range(num_repetitions):
        if rng is not None:
            rng.shuffle(ordering)
        node: RegionNode = root
        for vid in ordering[:-1]:
            remaining = [v for v in node.scope if v != vid]
            ptn = PartitionNode(node.scope)
            leaf = RegionNode([vid])
            rest = RegionNode(remaining)
            nodes.extend((ptn, leaf, rest))
            in_nodes[node].append(ptn)
            in_nodes[ptn] = [leaf, rest]
            node = rest
    return RegionGraph(nodes, dict(in_nodes), [root])


# pylint: disable-next=invalid-name
def RandomBinaryTree(
    num_variables: int, *, depth: int | None = None, num_repetitions: int = 1, seed: int = 42
) -> RegionGraph:
    """A region graph of repeated random binary vtrees (RAT-SPN-style)."""
    if num_variables <= 0:
        raise ValueError("The number of variables must be positive")
    if num_repetitions <= 0:
        raise ValueError("The number of repetitions must be positive")
    max_depth = int(np.ceil(np.log2(num_variables)))
    if depth is None:
        depth = max_depth
    elif depth < 0 or depth > max_depth:
        raise ValueError(f"The depth must be between 0 and {max_depth}")
    rng = np.random.RandomState(seed)
    root = RegionNode(range(num_variables))
    nodes: list[RegionGraphNode] = [root]
    in_nodes: dict[RegionGraphNode, list[RegionGraphNode]] = defaultdict(list)

    def random_bipartition(scope: Scope) -> list[Scope]:
        ids = list(scope)
        rng.shuffle(ids)
        half = int(round(len(ids) / 2))
        parts = [Scope(ids[:half]), Scope(ids[half:])]
        return [p for p in parts if p] or [Scope(ids)]

    for _ in range(num_repetitions):
        frontier: list[RegionNode] = [root]
        for _ in range(depth):
            next_frontier: list[RegionNode] = []
            for rgn in frontier:
                scopes = random_bipartition(rgn.scope)
                if len(scopes) == 1:
                    continue
                ptn = PartitionNode(rgn.scope)
                children = [RegionNode(s) for s in scopes]
                nodes.append(ptn)
                nodes.extend(children)
                in_nodes[rgn].append(ptn)
                in_nodes[ptn] = list(children)
                next_frontier.extend(children)
            frontier = next_frontier
    return RegionGraph(nodes, dict(in_nodes), [root])


def _quad_builder(
    shape: tuple[int, int, int], *, is_tree: bool, num_patch_splits: int = 2
) -> RegionGraph:
    """Shared Quad-Tree / Quad-Graph builder: merge 2x2 pixel patches
    bottom-up; the DAG variant adds both H-then-V and V-then-H partitionings
    to the merged region (ref: ``algorithms/quad.py:62-195``)."""
    if len(shape) != 3:
        raise ValueError("Quad region graphs only work for (C, H, W) images")
    num_channels, height, width = shape
    if num_channels <= 0 or height <= 0 or width <= 0:
        raise ValueError("The number of channels, height and width must be positive")
    if is_tree and num_patch_splits not in (2, 4):
        raise ValueError("The number of patch splits must be either 2 or 4")

    nodes: list[RegionGraphNode] = []
    in_nodes: dict[RegionGraphNode, list[RegionGraphNode]] = defaultdict(list)
    hypercube_to_scope = HypercubeToScope(shape)

    grid: list[list[RegionNode | None]] = [[None] * width for _ in range(height)]
    for i, j in itertools.product(range(height), range(width)):
        scope = hypercube_to_scope[((0, i, j), (num_channels, i + 1, j + 1))]
        rgn = RegionNode(scope)
        grid[i][j] = rgn
        nodes.append(rgn)

    def merge(rgn_in: list[RegionNode]) -> RegionNode:
        rgn = RegionNode(Scope.union(*(r.scope for r in rgn_in)))
        ptn = PartitionNode(rgn.scope)
        nodes.extend((rgn, ptn))
        in_nodes[rgn].append(ptn)
        in_nodes[ptn] = list(rgn_in)
        return rgn

    def merge4_tree(rgn_in: list[RegionNode]) -> RegionNode:
        if num_patch_splits == 2:
            top = merge(rgn_in[:2])
            bot = merge(rgn_in[2:])
            return merge([top, bot])
        return merge(rgn_in)

    def merge4_dag(rgn_in: list[RegionNode]) -> RegionNode:
        # Horizontal-then-vertical partitioning...
        top = merge([rgn_in[0], rgn_in[1]])
        bot = merge([rgn_in[2], rgn_in[3]])
        rgn = merge([top, bot])
        # ...plus the vertical-then-horizontal one on the same region node
        left = merge([rgn_in[0], rgn_in[2]])
        right = merge([rgn_in[1], rgn_in[3]])
        ptn = PartitionNode(rgn.scope)
        nodes.append(ptn)
        in_nodes[ptn] = [left, right]
        in_nodes[rgn].append(ptn)
        return rgn

    while height > 1 or width > 1:
        height = (height + 1) // 2
        width = (width + 1) // 2
        prev, grid = grid, [[None] * width for _ in range(height)]
        for i, j in itertools.product(range(height), range(width)):
            candidates = [
                prev[a][b]
                for a, b in (
                    (i * 2, j * 2),
                    (i * 2, j * 2 + 1),
                    (i * 2 + 1, j * 2),
                    (i * 2 + 1, j * 2 + 1),
                )
                if a < len(prev) and b < len(prev[0]) and prev[a][b] is not None
            ]
            if len(candidates) == 1:
                node = candidates[0]
            elif len(candidates) == 2:
                node = merge(candidates)
            elif is_tree:
                node = merge4_tree(candidates)
            else:
                node = merge4_dag(candidates)
            grid[i][j] = node

    return RegionGraph(nodes, dict(in_nodes), outputs=[grid[0][0]])


# pylint: disable-next=invalid-name
def QuadTree(shape: tuple[int, int, int], *, num_patch_splits: int = 2) -> RegionGraph:
    """The Quad-Tree region graph (structured decomposable)."""
    return _quad_builder(shape, is_tree=True, num_patch_splits=num_patch_splits)


# pylint: disable-next=invalid-name
def QuadGraph(shape: tuple[int, int, int]) -> RegionGraph:
    """The Quad-Graph region graph (both 2x2 partitionings per region)."""
    return _quad_builder(shape, is_tree=False)


# pylint: disable-next=invalid-name
def PoonDomingos(
    shape: tuple[int, int, int],
    *,
    delta: float | list[float] | list[list[float]],
    max_depth: int | None = None,
) -> RegionGraph:
    """The Poon-Domingos structure: BFS hypercube cutting at delta grid points."""
    axes = (1, 2)
    cut_points = _parse_pd_delta(delta, shape, axes)
    if max_depth is None:
        max_depth = sum(shape) + 1

    nodes: list[RegionGraphNode] = []
    in_nodes: dict[RegionGraphNode, list[RegionGraphNode]] = defaultdict(list)
    scope_region: dict[Scope, RegionNode] = {}
    hypercube_to_scope = HypercubeToScope(shape)

    def get_region(cube: HyperCube) -> RegionNode:
        scope = hypercube_to_scope[cube]
        rgn = scope_region.get(scope)
        if rgn is None:
            rgn = RegionNode(scope)
            scope_region[scope] = rgn
            nodes.append(rgn)
        return rgn

    root_cube: HyperCube = ((0,) * len(shape), tuple(shape))
    root = get_region(root_cube)
    queue: deque[HyperCube] = deque([root_cube])
    depth: dict[HyperCube, int] = {root_cube: 0}

    def cut(cube: HyperCube, axis: int, pt: int) -> list[HyperCube]:
        rgn = get_region(cube)
        p1, p2 = cube
        pieces: list[HyperCube] = []
        children: list[RegionNode] = []
        for lo, hi in itertools.pairwise([p1[axis], pt, p2[axis]]):
            a, b = list(p1), list(p2)
            a[axis], b[axis] = lo, hi
            piece = (tuple(a), tuple(b))
            pieces.append(piece)
            children.append(get_region(piece))
        ptn = PartitionNode(rgn.scope)
        nodes.append(ptn)
        in_nodes[rgn].append(ptn)
        in_nodes[ptn] = list(children)
        return pieces

    while queue:
        cube = queue.popleft()
        if depth[cube] > max_depth:
            continue
        found = False
        for cut_pts_i in cut_points:
            for ax, pts in zip(axes, cut_pts_i):
                for pt in pts:
                    if not cube[0][ax] < pt < cube[1][ax]:
                        continue
                    found = True
                    for piece in cut(cube, ax, pt):
                        if piece not in depth:
                            depth[piece] = depth[cube] + 1
                            queue.append(piece)
            if found:
                break

    return RegionGraph(nodes, dict(in_nodes), outputs=[root])


def _parse_pd_delta(
    delta: float | list[float] | list[list[float]],
    shape: Sequence[int],
    axes: Sequence[int],
) -> list[list[list[int]]]:
    if isinstance(delta, (float, int)):
        delta = [delta]
    deltas = [
        [d] * len(axes) if isinstance(d, (float, int)) else d for d in delta
    ]
    if any(len(d) != len(axes) for d in deltas):
        raise ValueError("Each delta list must have the same length as the cut axes")
    if any(dd < 1 for d in deltas for dd in d):
        raise ValueError("Each delta must be >= 1")
    cut_points: list[list[list[int]]] = []
    for d in deltas:
        per_axis: list[list[int]] = []
        for ax, d_ax in zip(axes, d):
            num_cuts = int((shape[ax] - 1) // d_ax)
            per_axis.append([int((j + 1) * d_ax) for j in range(num_cuts)])
        cut_points.append(per_axis)
    return cut_points


def tree2rg(tree: np.ndarray) -> RegionGraph:
    """Convert a predecessor-list tree (tree[i] = parent of i, -1 at the
    root) into an HCLT region graph (ref: ``algorithms/utils.py:73-131``)."""
    tree = np.asarray(tree)
    num_variables = len(tree)
    nodes: list[RegionGraphNode] = []
    in_nodes: dict[RegionGraphNode, list[RegionGraphNode]] = defaultdict(list)
    partitions: list[PartitionNode | None] = [None] * num_variables

    # Each non-leaf vertex v gets a partition whose scope is v plus the
    # subtree scopes of its children; grow scopes by walking each leaf-to-root
    # path (same accumulation as the reference).
    for v in range(num_variables):
        cur_v, prev_v = v, int(tree[v])
        while prev_v != -1:
            prev_partition = partitions[prev_v]
            if prev_partition is None:
                partitions[prev_v] = PartitionNode(Scope([v, prev_v]))
            else:
                partitions[prev_v] = PartitionNode(Scope([v]) | prev_partition.scope)
            cur_v, prev_v = prev_v, int(tree[cur_v])

    nodes.extend(p for p in partitions if p is not None)

    regions: list[RegionNode | None] = [None] * num_variables
    for cur_v in range(num_variables):
        prev_v = int(tree[cur_v])
        leaf = RegionNode([cur_v])
        nodes.append(leaf)
        cur_partition = partitions[cur_v]
        if cur_partition is None:
            if prev_v != -1:
                in_nodes[partitions[prev_v]].append(leaf)
            regions[cur_v] = leaf
        else:
            in_nodes[cur_partition].append(leaf)
            cur_region = regions[cur_v]
            if cur_region is None:
                cur_region = RegionNode(cur_partition.scope)
                regions[cur_v] = cur_region
                nodes.append(cur_region)
            in_nodes[cur_region].append(cur_partition)
            if prev_v != -1:
                in_nodes[partitions[prev_v]].append(cur_region)

    outputs = [regions[v] for v, p in enumerate(tree) if int(p) == -1]
    return RegionGraph(nodes, dict(in_nodes), outputs=outputs)


# pylint: disable-next=invalid-name
def ChowLiuTree(
    data: np.ndarray,
    input_type: str | list[str],
    root: int | None = None,
    chunk_size: int | None = None,
    num_categories: int | None = None,
    num_bins: int | None = None,
    as_region_graph: bool = True,
) -> np.ndarray | RegionGraph:
    """Learn a Chow-Liu tree from data: build the pairwise mutual-information
    matrix, take its maximum spanning tree, and (optionally) return it as an
    HCLT region graph (ref: ``algorithms/chow_liu.py``)."""
    data = np.asarray(data)
    if data.ndim != 2:
        raise ValueError("The data must be a (num_samples, num_features) matrix")
    if root is not None and not -1 < root < data.shape[1]:
        raise ValueError("The root variable index is out of range")
    if isinstance(input_type, list):
        mutual_info = _heterogeneous_mutual_info(
            data, is_categorical_mask=[t == "categorical" for t in input_type]
        )
    elif input_type == "categorical":
        if num_bins is not None:
            if num_categories is None:
                raise ValueError("The number of categories must be known when binning")
            data = data // (num_categories // num_bins)
        mutual_info = _categorical_mutual_info(
            data.astype(np.int64), num_categories=num_categories, chunk_size=chunk_size
        )
    elif input_type == "gaussian":
        corr = np.corrcoef(data.T)
        # clip |corr| away from 1 so perfectly-correlated pairs get a large
        # finite MI instead of inf (their edge is still always selected)
        mutual_info = -0.5 * np.log(np.maximum(1.0 - corr**2, 1e-12))
    else:
        raise NotImplementedError(f"MI computation not implemented for {input_type} inputs")

    _, tree = _maximum_spanning_tree(mutual_info, root=root)
    if as_region_graph:
        return tree2rg(tree)
    return tree


def _maximum_spanning_tree(
    adj_matrix: np.ndarray, root: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Maximum spanning tree as a predecessor list rooted at ``root``.

    Attribution: this is a direct numpy port of the reference's host-side MST
    construction (``cirkit/templates/region_graph/algorithms/chow_liu.py:
    84-106``), including its negate-and-shift trick for turning scipy's
    minimum spanning tree into a maximum one over non-negative MI weights and
    its eccentricity-minimizing root choice. The algorithm is the classic
    Chow-Liu/HCLT recipe (Chow & Liu 1968; Liu & Van den Broeck 2021); it is
    O(D^2) host-side scipy work with no device-side alternative, so it is kept
    as a cited port rather than re-expressed.
    """
    mst = sp.csgraph.minimum_spanning_tree(-(np.asarray(adj_matrix) + 1.0), overwrite=True)
    if root is None:
        dist = sp.csgraph.dijkstra(np.abs(mst.todense()), directed=False)
        root = int(np.argmin(np.max(dist, axis=1)))
    bfs, tree = sp.csgraph.breadth_first_order(
        mst, directed=False, i_start=root, return_predecessors=True
    )
    tree = np.asarray(tree)
    tree[root] = -1
    return bfs, tree


def _categorical_mutual_info(
    data: np.ndarray,
    alpha: float = 0.01,
    num_categories: int | None = None,
    chunk_size: int | None = None,
) -> np.ndarray:
    """Pairwise MI of integer data with Laplace smoothing.

    Attribution: a numpy port of the reference's torch implementation
    (``cirkit/templates/region_graph/algorithms/chow_liu.py:109-151``) — the
    chunked pairwise joint-count accumulation, the Laplace-correction
    sequence (including the exact diagonal fix), and the
    ``sum(p * (log p - log q))`` MI estimate follow it step for step. This is
    host-side preprocessing for ChowLiuTree (runs once, on numpy, before any
    circuit exists), so a device-side redesign does not apply; kept as a cited
    port per the never-copy rule.
    """
    n_samples, n_features = data.shape
    if num_categories is None:
        num_categories = int(data.max()) + 1
    if chunk_size is None:
        chunk_size = n_samples

    joint_counts = np.zeros(
        (n_features, n_features, num_categories * num_categories), dtype=np.int64
    )
    for start in range(0, n_samples, chunk_size):
        chunk = data[start : start + chunk_size]
        joint_values = chunk.T[:, None, :] * num_categories + chunk.T[None, :, :]
        np.add.at(
            joint_counts,
            (
                np.arange(n_features)[:, None, None],
                np.arange(n_features)[None, :, None],
                joint_values,
            ),
            1,
        )
    joint_counts = joint_counts.reshape(n_features, n_features, num_categories, num_categories)
    idx = np.arange(n_features)
    marginal_counts = joint_counts[idx, idx][:, np.arange(num_categories), np.arange(num_categories)]

    marginals = (marginal_counts + num_categories * alpha) / (
        n_samples + num_categories**2 * alpha
    )
    joints = (joint_counts + alpha) / (n_samples + num_categories**2 * alpha)
    # correct Laplace smoothing on the diagonal: joint of (i, i) is the marginal
    for i in idx:
        joints[i, i] = np.diag(marginals[i])
    outers = np.einsum("ik,jl->ijkl", marginals, marginals)
    # The diagonal blocks contain structural zeros (joint of a variable with
    # itself); the resulting nan/inf terms only land on the diagonal of the
    # MI matrix, which is zeroed below.
    with np.errstate(divide="ignore", invalid="ignore"):
        mi = (joints * (np.log(joints) - np.log(outers))).sum(axis=(2, 3))
    np.fill_diagonal(mi, 0.0)
    return mi


def _heterogeneous_mutual_info(
    data: np.ndarray, is_categorical_mask: list[bool], normalize: bool = True
) -> np.ndarray:
    """Pairwise MI for mixed categorical/continuous data; continuous pairs use
    the Gaussian formula, mixed pairs use I(C, D) = H(C) - H(C | D)."""
    eps = 1e-4
    is_cat = np.asarray(is_categorical_mask, dtype=bool)
    cont = np.where(~is_cat)[0]
    disc = np.where(is_cat)[0]
    n = data.shape[1]
    mi = np.zeros((n, n))

    if len(cont) > 1:
        corr = np.corrcoef(data[:, cont].T)
        np.fill_diagonal(corr, 0.0)
        mi[np.ix_(cont, cont)] = -0.5 * np.log(1 - corr**2)
    if len(disc) > 1:
        mi[np.ix_(disc, disc)] = _categorical_mutual_info(data[:, disc].astype(np.int64))

    def gaussian_entropy(x: np.ndarray) -> float:
        return float(0.5 * (np.log(2 * np.pi * np.var(x) + eps) + 1))

    num_cats = {d: int(data[:, d].max()) + 1 for d in disc}
    p_d = {
        d: np.bincount(data[:, d].astype(np.int64), minlength=num_cats[d]) / data.shape[0]
        for d in disc
    }
    h_c = {c: gaussian_entropy(data[:, c]) for c in cont}

    for c in cont:
        for d in disc:
            h_given = np.array(
                [gaussian_entropy(data[:, c][data[:, d] == i]) for i in range(num_cats[d])]
            )
            mi[c, d] = mi[d, c] = h_c[c] - float((h_given * p_d[d]).sum())

    if normalize:
        entropy = np.zeros(n)
        entropy[cont] = [h_c[c] for c in cont]
        entropy[disc] = [
            -(np.log(p[p > 0]) * p[p > 0]).sum() for p in (p_d[d] for d in disc)
        ]
        mi = 2 * mi / (entropy[None, :] + entropy[:, None])
    np.fill_diagonal(mi, 0.0)
    return mi
