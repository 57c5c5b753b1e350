"""annembed_tpu_torch — the PyTorch / CUDA port of ``annembed_tpu``.

Same module layout and names as the JAX package, which stays the
reference the port is tested against.  This package imports torch and
never jax (nor ``annembed_tpu``, whose import pulls in jax).  Its one
hand-written kernel, ``csrc/top1_l2.cu``, carries the hierarchical
projection (``ops/top1.py``).  Entry points: ``embed`` / ``dmap_embed``,
``python -m annembed_tpu_torch.cli embed|dmapembed`` and the bench,
``python -m annembed_tpu_torch.bench``.

Public surface: embed, dmap_embed, quality_estimate, QualityEstimate,
Embedder, DiffusionMaps, EmbedderParams, DiffusionParams, KnnParams,
KGraph, NodeParams, to_proba_edges, build_kgraph, recall_at_k,
build_projection, KGraphProjection, and the by-product estimators
hdbscan, single_linkage, HdbscanResult, outlier_scores,
intrinsic_dim_levina_bickel, intrinsic_dim_2nn, Hubness.
"""

from .params import (EmbedderParams, DiffusionParams, KnnParams, PROBA_MIN)
from .api import dmap_embed, embed
from .estimators.dimension import (intrinsic_dim_2nn,
                                   intrinsic_dim_levina_bickel)
from .estimators.hdbscan import (HdbscanResult, hdbscan, outlier_scores,
                                 single_linkage)
from .estimators.hubness import Hubness
from .estimators.quality import QualityEstimate, quality_estimate
from .graph.kgraph import KGraph
from .graph.proba import to_proba_edges, NodeParams
from .knn.api import build_kgraph, recall_at_k
from .knn.hierarchy import build_projection, KGraphProjection
from .optim.embedder import Embedder
from .spectral.diffmaps import DiffusionMaps

__version__ = "0.1.0"

__all__ = [
    "embed", "dmap_embed", "quality_estimate", "QualityEstimate",
    "Embedder", "DiffusionMaps", "EmbedderParams", "DiffusionParams",
    "KnnParams", "PROBA_MIN", "KGraph", "NodeParams", "to_proba_edges",
    "build_kgraph", "recall_at_k", "build_projection", "KGraphProjection",
    "intrinsic_dim_levina_bickel", "intrinsic_dim_2nn", "Hubness",
    "hdbscan", "single_linkage", "HdbscanResult", "outlier_scores",
]
