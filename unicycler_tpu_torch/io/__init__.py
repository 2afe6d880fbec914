from .fastx import (Read, Reference, load_references, load_long_reads,
                    load_fasta, load_fasta_with_full_header)
