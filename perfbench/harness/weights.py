"""Weights of a language-model configuration, made from the run's seed on
the card: one ``torch.randn`` per leaf (the stacked layers' leaves hold all
layers), each leaf from its own generator, so that the program's masters
and the reference's copy are the same numbers and any leaf can be drawn
again alone.

The leaves, with their paths, shapes and kinds, are the architecture's
(``archs/<architecture>.leaves``), named as the program's parameter tree
names them (the tree the train step takes); scales follow the usual init of such a model:
a linear map's weight N(0, 1/d_in), the embedding table N(0, 1/d), norm
scales 1.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from perfbench.harness import gen

def leaf(seed: int, i: int, shape, kind: str, device) -> torch.Tensor:
    """Leaf ``i`` in float32: ones, or N(0, 1) x 1/sqrt(fan), the fan a
    linear map's input (the second-to-last axis) or the embedding's width
    (the table's last axis)."""
    if kind == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(gen.sub_seed(seed, 100, i))
    out = torch.randn(shape, generator=g, dtype=torch.float32, device=device)
    fan = shape[-1] if kind == "embedding" else shape[-2]
    return out.mul_(fan ** -0.5)


def nest(pairs) -> Dict[str, Any]:
    """{path: value} as the nested dict the program's tree is."""
    tree: Dict[str, Any] = {}
    for path, value in pairs:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def get(tree, path):
    for key in path:
        tree = tree[key]
    return tree
