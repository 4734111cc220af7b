"""repro_torch.phylo — the phylogeny stage of the port (dense NJ only)."""
from .engine import (PhyloResult, REFINE_MODES, TREE_BACKENDS,  # noqa: F401
                     TreeEngine, resolve_tree_backend)
