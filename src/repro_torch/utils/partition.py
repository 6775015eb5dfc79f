"""Path-based tree partitioning, used to train the LoRA leaves only (the
reference's ``utils/partition.py``).

``partition_by_path(tree, pred)`` returns the selected leaves (a flat list,
the tree of the gradients and the optimizer state) and a merge function
that puts leaves back into the full tree. The base model stays frozen by
never being among the differentiated leaves.
"""
from __future__ import annotations

from typing import Callable, List

from repro_torch.utils.tree import flatten, flatten_with_path, unflatten


def partition_by_path(tree, pred: Callable[[str], bool]):
    paths_leaves = flatten_with_path(tree)
    treedef = flatten(tree)[1]
    sel_idx = [i for i, (p, _) in enumerate(paths_leaves) if pred(p)]
    sel_set = set(sel_idx)
    sel = [paths_leaves[i][1] for i in sel_idx]
    rest = [leaf for i, (_, leaf) in enumerate(paths_leaves)
            if i not in sel_set]

    def merge(sel_leaves: List):
        if len(sel_leaves) != len(sel_idx):
            raise ValueError(f"merge takes {len(sel_idx)} leaves, got "
                             f"{len(sel_leaves)}")
        it_sel, it_rest = iter(sel_leaves), iter(rest)
        out = [next(it_sel) if i in sel_set else next(it_rest)
               for i in range(len(paths_leaves))]
        return unflatten(treedef, out)

    return sel, merge


def is_lora_path(path: str) -> bool:
    return "lora" in path.split("/")


def select_paths(tree, pred: Callable[[str], bool]):
    """Just the selected (path, leaf) pairs."""
    return [(p, leaf) for p, leaf in flatten_with_path(tree) if pred(p)]
