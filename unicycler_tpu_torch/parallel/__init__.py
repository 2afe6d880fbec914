from .mesh import get_mesh, sharded_banded_align, sharded_align_stats
