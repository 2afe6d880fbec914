"""python -m unicycler_tpu_torch: the command line of the port (CUDA)."""

from .pipeline.main import main

if __name__ == '__main__':
    main()
