"""Process bodies for the port's multi-process tests
(test_torch_distributed*.py).

These run in spawned children, which must import torch and the port
only: this module imports neither jax nor unicycler_tpu, so a child that
unpickles one of its functions stays free of them. The JAX package's
reference results are computed in the test's own process.
"""

import os
import random
import socket
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port():
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def alignment_workload():
    """test_distributed.py's workload: six reads with ~2.7% substitutions
    over one 3 kbp reference."""
    rng = np.random.RandomState(42)
    ref_seq = ''.join('ACGT'[b] for b in rng.randint(0, 4, 3000))
    reads = []
    for i in range(6):
        start = 200 * i
        seq = list(ref_seq[start:start + 400])
        for p in range(0, 400, 37):
            seq[p] = 'ACGT'[(('ACGT'.index(seq[p])) + 1) % 4]
        reads.append(('read_%d' % i, ''.join(seq)))
    return ref_seq, reads


ALIGN_KWARGS = dict(sensitivity_level=0, low_score_threshold=60.0,
                    min_align_length=20)


def alignment_map(reads):
    """read name -> sorted alignment tuples (coordinates, scores, CIGAR)."""
    return {read.name: sorted(
        (a.ref.name, bool(a.rev_comp), int(a.read_start_pos),
         int(a.read_end_pos), int(a.ref_start_pos), int(a.ref_end_pos),
         int(a.raw_score), round(float(a.scaled_score), 6),
         ''.join(a.cigar_parts))
        for a in read.alignments) for read in reads}


def pipeline_genome():
    """test_distributed_pipeline.py's 9.8 kbp genome: two unique parts
    and two copies of a 400 bp repeat."""
    rng = random.Random(4242)
    repeat = ''.join(rng.choice('ACGT') for _ in range(400))
    a = ''.join(rng.choice('ACGT') for _ in range(5000))
    b = ''.join(rng.choice('ACGT') for _ in range(4000))
    return a + repeat + b + repeat


def pipeline_argv(data_dir, out):
    return ['-1', os.path.join(data_dir, 'r1.fastq'),
            '-2', os.path.join(data_dir, 'r2.fastq'),
            '-l', os.path.join(data_dir, 'long.fastq'),
            '-o', out, '--verbosity', '0', '--keep', '0',
            '--min_fasta_length', '100', '--no_rotate']


def _join(rank, world, port):
    import torch
    torch.set_num_threads(1)
    if port is not None:
        os.environ['UNICYCLER_TPU_COORDINATOR'] = 'localhost:%d' % port
        os.environ['UNICYCLER_TPU_NUM_PROCESSES'] = str(world)
        os.environ['UNICYCLER_TPU_PROCESS_ID'] = str(rank)
    sys.path.insert(0, ROOT)


def align_rank(rank, world, port):
    """One rank of the two-rank alignment: allgather_bytes on unequal and
    empty payloads, then distributed_align_long_reads on the CPU."""
    _join(rank, world, port)
    from unicycler_tpu_torch.align.scoring import AlignmentScoringScheme
    from unicycler_tpu_torch.io.fastx import Read, Reference
    from unicycler_tpu_torch.parallel import distributed as dist
    ctx = dist.maybe_initialize()
    gathered = [dist.allgather_bytes(b'' if rank == 0 else b'rank%d' % rank
                                     * (rank + 2), ctx),
                dist.allgather_bytes(b'', ctx),
                dist.allgather_object({'rank': rank}, ctx)]
    ref_seq, read_data = alignment_workload()
    reads = [Read(name, seq, '+' * len(seq)) for name, seq in read_data]
    n_local = dist.distributed_align_long_reads(
        reads, [Reference('ref', ref_seq)],
        AlignmentScoringScheme('3,-6,-5,-2'), ctx=ctx, device='cpu',
        **ALIGN_KWARGS)
    assert 'jax' not in sys.modules and 'unicycler_tpu' not in sys.modules
    return ctx.index, ctx.count, n_local, gathered, alignment_map(reads)


def pipeline_rank(rank, world, port, data_dir, out_dir):
    """One rank of the port's command line on the CPU; returns its
    assembly.fasta and whether it wrote a log file."""
    _join(rank, world, port)
    from unicycler_tpu_torch.pipeline.main import main
    out = os.path.join(out_dir, 'p%d' % rank)
    main(pipeline_argv(data_dir, out), device='cpu')
    with open(os.path.join(out, 'assembly.fasta')) as f:
        fasta = f.read()
    assert 'jax' not in sys.modules and 'unicycler_tpu' not in sys.modules
    return fasta, os.path.exists(os.path.join(out,
                                              'unicycler_tpu_torch.log'))


def run(fn, args, q):
    """Child entry: put (rank, result) or (rank, 'ERROR ...') on q."""
    try:
        q.put((args[0], fn(*args)))
    except BaseException as exc:            # surface in the parent
        import traceback
        q.put((args[0], 'ERROR %r\n%s' % (exc, traceback.format_exc())))
        raise


def run_ranks(fn, world, extra=(), timeout=600, meanwhile=None):
    """Spawn `world` ranks of fn meeting on a free localhost port (calling
    meanwhile(), if given, in this process while they run); returns their
    results by rank, raising on a child's error or a timeout."""
    import multiprocessing as mp
    ctx = mp.get_context('spawn')
    port = free_port()
    q = ctx.Queue()
    procs = [ctx.Process(target=run, args=(fn, (i, world, port) + tuple(extra),
                                           q))
             for i in range(world)]
    for p in procs:
        p.start()
    outs = {}
    try:
        if meanwhile is not None:
            meanwhile()
        for _ in range(world):
            rank, out = q.get(timeout=timeout)
            if isinstance(out, str) and out.startswith('ERROR'):
                raise AssertionError('rank %d failed: %s' % (rank, out))
            outs[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
    return [outs[i] for i in range(world)]
