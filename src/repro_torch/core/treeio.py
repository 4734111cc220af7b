"""Tree utilities: Newick export, bipartitions, Robinson-Foulds distance,
and host-side stitching of HPTree cluster subtrees. Host numpy code by
design — trees leave the device as small arrays and these run once per
analysis."""
from __future__ import annotations

from typing import Optional, Sequence, Set, FrozenSet

import numpy as np


def to_newick(children: np.ndarray, blen: np.ndarray, root: int,
              names: Optional[Sequence[str]] = None,
              support: Optional[np.ndarray] = None) -> str:
    """Newick string via iterative postorder (matching ``leaf_sets``) —
    NJ can emit caterpillar-deep trees that blow Python's recursion limit
    around ~1000 leaves.

    ``support`` (optional, per-node) emits bootstrap support as internal
    node labels — ``(a:0.1,b:0.2)0.97:0.3`` — for every node with a
    finite entry (leaves, the root, and trivial splits carry NaN, the
    standard convention).
    """
    children = np.asarray(children)
    blen = np.asarray(blen)
    if support is not None:
        support = np.asarray(support)
    frag: dict[int, str] = {}
    stack = [(int(root), False)]
    while stack:
        node, seen = stack.pop()
        c = children[node]
        if c[0] < 0:
            frag[node] = names[node] if names else f"t{node}"
        elif not seen:
            stack.append((node, True))
            stack.append((int(c[0]), False))
            stack.append((int(c[1]), False))
        else:
            left = f"{frag.pop(int(c[0]))}:{float(blen[node, 0]):.6f}"
            right = f"{frag.pop(int(c[1]))}:{float(blen[node, 1]):.6f}"
            label = ""
            if support is not None and np.isfinite(support[node]):
                label = f"{float(support[node]):.2f}"
            frag[node] = f"({left},{right}){label}"
    return frag[int(root)] + ";"


def leaf_sets(children: np.ndarray, root: int, n_leaves: int):
    """Per-node frozenset of descendant leaves (iterative postorder)."""
    children = np.asarray(children)
    memo: dict[int, FrozenSet[int]] = {}
    stack = [(int(root), False)]
    while stack:
        node, seen = stack.pop()
        c = children[node]
        if c[0] < 0:
            memo[node] = frozenset([node])
            continue
        if not seen:
            stack.append((node, True))
            stack.append((int(c[0]), False))
            stack.append((int(c[1]), False))
        else:
            memo[node] = memo[int(c[0])] | memo[int(c[1])]
    return memo


def canonical_split(s: FrozenSet[int], all_leaves: FrozenSet[int]
                    ) -> FrozenSet[int]:
    """The canonical side of a bipartition (smaller set, sorted tiebreak).

    Every split comparison must canonicalize through this one function
    or lookups silently miss.
    """
    return min(s, all_leaves - s, key=lambda x: (len(x), sorted(x)))


def bipartitions(children: np.ndarray, root: int, n_leaves: int) -> Set[FrozenSet[int]]:
    """Non-trivial splits of the (implicitly unrooted) tree."""
    memo = leaf_sets(children, root, n_leaves)
    all_leaves = frozenset(range(n_leaves))
    splits = set()
    for node, s in memo.items():
        if node == root:
            continue
        if 1 < len(s) < n_leaves - 1:
            splits.add(canonical_split(s, all_leaves))
    return splits


def rf_distance(tree_a, tree_b, n_leaves: int) -> int:
    """Robinson-Foulds distance between two trees over the same leaf ids."""
    sa = bipartitions(np.asarray(tree_a.children), int(tree_a.root), n_leaves)
    sb = bipartitions(np.asarray(tree_b.children), int(tree_b.root), n_leaves)
    return len(sa ^ sb)


def normalized_rf(tree_a, tree_b, n_leaves: int) -> float:
    rf = rf_distance(tree_a, tree_b, n_leaves)
    denom = 2.0 * max(n_leaves - 3, 1)
    return rf / denom


def stitch_cluster_trees(skeleton_children, skeleton_blen, skeleton_root,
                         cluster_trees, cluster_members):
    """Replace skeleton leaf c with cluster c's subtree (HPTree merge step).

    cluster_trees: list of (children, blen, root, size) in *local* leaf ids;
    cluster_members: list of arrays mapping local leaf id -> global leaf id.
    Returns (children, blen, root) in global ids.
    """
    skeleton_children = np.asarray(skeleton_children)
    skeleton_blen = np.asarray(skeleton_blen)
    n_global = sum(len(m) for m in cluster_members)
    # allocate: global leaves, then every cluster's internals, then skeleton's
    children_out = []
    blen_out = []
    next_id = n_global

    def alloc():
        nonlocal next_id
        children_out.append([-1, -1])
        blen_out.append([0.0, 0.0])
        next_id += 1
        return next_id - 1

    def copy_tree(ch, bl, root, leaf_id):
        """Re-emit the subtree at ``root`` into the global arrays, mapping
        leaf ``n`` through ``leaf_id``. Iterative postorder — cluster and
        skeleton NJ trees can be caterpillar-deep (same hazard as
        ``to_newick``)."""
        mapped: dict[int, int] = {}
        stack = [(int(root), False)]
        while stack:
            node, seen = stack.pop()
            c = ch[node]
            if c[0] < 0:
                mapped[node] = leaf_id(node)
            elif not seen:
                stack.append((node, True))
                stack.append((int(c[1]), False))   # c0 pops (and allocs) first,
                stack.append((int(c[0]), False))   # matching the old recursion
            else:
                nid = alloc()
                children_out[nid - n_global] = [mapped[int(c[0])],
                                                mapped[int(c[1])]]
                blen_out[nid - n_global] = [float(bl[node, 0]),
                                            float(bl[node, 1])]
                mapped[node] = nid
        return mapped[int(root)]

    cluster_root_global = []
    for (ch, bl, root, size), members in zip(cluster_trees, cluster_members):
        ch, bl = np.asarray(ch), np.asarray(bl)
        if int(size) == 1:
            cluster_root_global.append(int(members[0]))
        else:
            cluster_root_global.append(
                copy_tree(ch, bl, root, lambda n: int(members[n])))

    root = copy_tree(skeleton_children, skeleton_blen, skeleton_root,
                     lambda n: cluster_root_global[n])
    children = np.full((next_id, 2), -1, np.int32)
    blen = np.zeros((next_id, 2), np.float32)
    if children_out:
        children[n_global:] = np.asarray(children_out, np.int32)
        blen[n_global:] = np.asarray(blen_out, np.float32)
    return children, blen, root
