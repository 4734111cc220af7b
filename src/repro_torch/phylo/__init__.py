"""repro_torch.phylo — the phylogeny stage of the port: the tree engine,
the distance tiles, the tiled HPTree pipeline, the substitution-model
registry, ML refinement with bootstrap support, and the restartable
multi-start tree search."""
from .engine import (AUTO_TILED_N, PhyloResult, REFINE_MODES,  # noqa: F401
                     TREE_BACKENDS, TreeEngine, resolve_tree_backend)
from .ml import MLRefiner, MLResult  # noqa: F401
from .models import MODELS  # noqa: F401
from .pipeline import tiled_phylogeny  # noqa: F401
from .tiles import TileAccountant, TileContext  # noqa: F401
from .treesearch import (TreeSearcher, TreeSearchResult,  # noqa: F401
                         fleet_starts, spr_candidates)
