from .scoring import AlignmentScoringScheme
from .alignment import Alignment
