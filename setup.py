"""Package installation for unicycler_tpu.

The native traceback decoder (unicycler_tpu/native/cigar_decode.cpp) is
built lazily at first use with g++ via ctypes, so no compilation happens
at install time (the reference compiles its C++ in setup.py,
ref setup.py:85-111; here the compute path is JAX/Pallas and only a small
host-side helper is native).

unicycler_tpu_torch, the PyTorch/CUDA port, ships its CUDA sources
(csrc/*.cu) and host C++ (native/*.cpp) the same way: nvcc and g++ build
them at first use. Its command line is the unicycler_tpu_torch console
script (python -m unicycler_tpu_torch), with its own copy of the start
genes (gene_data/).
"""

from setuptools import find_packages, setup

setup(
    name='unicycler_tpu',
    version='0.1.0',
    description='TPU-native hybrid bacterial genome assembly framework',
    packages=find_packages(exclude=['tests']),
    package_data={'unicycler_tpu': ['native/*.cpp'],
                  'unicycler_tpu_torch': ['csrc/*.cu', 'native/*.cpp',
                                          'gene_data/*.fasta',
                                          'gene_data/README.md']},
    python_requires='>=3.10',
    install_requires=['numpy', 'jax'],
    entry_points={
        'console_scripts':
            ['unicycler_tpu = unicycler_tpu.pipeline.main:main',
             'unicycler_tpu_torch = unicycler_tpu_torch.pipeline.main:main'],
    },
)
