"""Operations and bytes of the DP kernels, counted from the work handed
to the program's entry (tasks and the alignments they gave), never from
the program's own launch layout, so that a change of layout cannot move
the yardstick."""
