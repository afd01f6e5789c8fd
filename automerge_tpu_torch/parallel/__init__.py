"""The sharded merge over a mesh of shards (``parallel/sharding.py``)."""

from .collectives import Mesh, default_mesh
from .sharding import make_sharded_merge, sharded_merge_columns

__all__ = ["Mesh", "default_mesh", "make_sharded_merge", "sharded_merge_columns"]
