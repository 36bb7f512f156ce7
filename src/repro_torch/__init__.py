"""PyTorch/CUDA port of the hierarchical near-neighbor interaction system.

Mirrors the module paths of the JAX package ``repro`` (the reference this
port is held against) and imports none of it. The ported slice is the
paper's main path, ``api.build_plan(x)`` -> ``plan.matvec(charges)``:
kNN pattern -> principal-axis embedding -> 2^d-tree ordering -> gamma
score -> two-level ELL-BSR storage -> block-segment SpMV, the last two
through hand-written CUDA kernels (``repro_torch.kernels``).

Every public entry point takes ``device=None``, and ``None`` means
``"cuda"``: with no card present it raises instead of carrying on on the
CPU. Pass ``device="cpu"`` explicitly for the plain PyTorch paths.
"""
