"""Structure-preserving maps over the port's state containers.

The JAX package relies on pytrees (flax.struct dataclasses, NamedTuples)
and `jax.tree_util.tree_map`; the port's states are plain dataclasses of
tensors, mapped field by field here."""
from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, tree, *rest):
    """Apply `fn` leafwise over tensors nested in dataclasses."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    raise TypeError(f"unsupported tree node {type(tree).__name__}")


def tree_leaves(tree) -> list:
    """The tensors nested in dataclasses, in field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in tree_leaves(getattr(tree, f.name))]
    raise TypeError(f"unsupported tree node {type(tree).__name__}")
