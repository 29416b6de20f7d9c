"""Lazy, chunked, demand-driven trace DAG — the functional core.

Device-first redesign of the reference's BufferedData graph
(`src/audian/data.py`, `src/audian/buffereddata.py`): immutable specs,
pure node compute functions, host-side geometry, one fused XLA program per
chunk shape.
"""

from .spec import TraceSpec
from .nodes import Node, FilterNode, EnvelopeNode, SpectrogramNode
from .graph import TraceGraph, MissingSourceError, RAW
from .executor import GraphExecutor

__all__ = [
    "TraceSpec",
    "Node",
    "FilterNode",
    "EnvelopeNode",
    "SpectrogramNode",
    "TraceGraph",
    "MissingSourceError",
    "GraphExecutor",
    "RAW",
]
