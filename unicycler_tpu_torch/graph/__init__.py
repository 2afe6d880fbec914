from .segment import Segment
from .assembly_graph import (AssemblyGraph, BadOverlaps, BadPath,
                             CannotTrimOverlaps)
