"""repro_torch.phylo — the phylogeny stage of the port: the tree engine,
the distance tiles and the tiled HPTree pipeline."""
from .engine import (AUTO_TILED_N, PhyloResult, REFINE_MODES,  # noqa: F401
                     TREE_BACKENDS, TreeEngine, resolve_tree_backend)
from .pipeline import tiled_phylogeny  # noqa: F401
from .tiles import TileAccountant, TileContext  # noqa: F401
