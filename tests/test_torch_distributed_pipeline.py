"""Two ranks of the port's command line over gloo, against the JAX
package's single-process command line.

test_distributed_pipeline.py's 9.8 kbp genome (a 400 bp repeat in two
copies) with fake pairs and long reads; the port's main runs in two
spawned ranks on the CPU (the long-read alignment sharded over them and
allgathered, the graph stages replicated), the JAX package's main once in
this process. Both ranks' assembly.fasta must be byte-equal to each other
and to the JAX package's; only rank 0 writes a log file.
"""

import os

import torch_dist_workers as w


def test_two_rank_pipeline_matches_jax(tmp_path):
    from unicycler_tpu.pipeline.fake_reads import (make_fake_long_reads,
                                                   make_fake_short_reads,
                                                   write_fastq)
    from unicycler_tpu.pipeline.main import main as jmain
    genome = w.pipeline_genome()
    data_dir = str(tmp_path / 'data')
    os.makedirs(data_dir)
    p1, p2 = make_fake_short_reads(genome)
    write_fastq(os.path.join(data_dir, 'r1.fastq'), p1)
    write_fastq(os.path.join(data_dir, 'r2.fastq'), p2)
    write_fastq(os.path.join(data_dir, 'long.fastq'),
                make_fake_long_reads(genome, read_length=3000, step=500))
    jax_out = str(tmp_path / 'jax')
    outs = w.run_ranks(w.pipeline_rank, 2,
                       extra=(data_dir, str(tmp_path / 'multi')),
                       timeout=1200,
                       meanwhile=lambda: jmain(w.pipeline_argv(data_dir,
                                                               jax_out)))
    with open(os.path.join(jax_out, 'assembly.fasta')) as f:
        want = f.read()
    assert '>' in want
    assert outs[0][0] == outs[1][0] == want
    assert [has_log for _, has_log in outs] == [True, False]
