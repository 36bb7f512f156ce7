"""The paper's OWN experiment configuration (§4): dataset sizes, neighbor
counts, orderings and block sizes. Kept as a config module so scripts and
the core library share one source of truth."""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class SpMVExperiment:
    dataset: str              # "sift" (128-d) | "gist" (960-d) stand-ins
    n_points: int
    k_neighbors: int
    sigma: float              # gamma-score scale (paper: k/2)
    orderings: Tuple[str, ...] = ("scattered", "rcm", "pca_1d",
                                  "lex2", "lex3", "dual_tree")
    tile: int = 32            # bottom-level dense tile
    superblock: int = 8       # level-2 grouping, in tiles


TABLE1 = (
    SpMVExperiment("sift", 4096, 30, 15.0),
    SpMVExperiment("gist", 4096, 90, 45.0),
)

FIG3 = (
    SpMVExperiment("sift", 4096, 30, 15.0),
    SpMVExperiment("gist", 2048, 45, 22.5),
)

MICRO = {"n": 8192, "tile": 32, "tiles_per_row": 16}
