"""apsim: exact all-pairs similarity search engine for accelerators.

A from-scratch JAX/XLA rebuild of the capabilities of
``mcgill-cpslab/all-pairs-similarity`` (an Akka/Spark streaming similarity
join): inverted-index semantics re-expressed as dense matmul scoring over a
compact frequency-ordered dimension space, with exact fp64 pair-set parity,
streaming micro-batch inserts, top-k queries, and dim-sharded mesh scale-out.

See SURVEY.md for the structural analysis of the reference system.
"""

from .config import AllPairsConfig, load_config
from .engine.engine import Engine
from .engine.output import PairResult, SimilarityOutput
from .vector.sparse import DenseVector, SparseVector, Vectors, parse_vector

__version__ = "0.1.0"

__all__ = [
    "AllPairsConfig",
    "load_config",
    "Engine",
    "PairResult",
    "SimilarityOutput",
    "SparseVector",
    "DenseVector",
    "Vectors",
    "parse_vector",
]
