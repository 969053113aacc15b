"""tf_gnn_samples_torch: the PyTorch/CUDA port of tf_gnn_samples_tpu.

Same module layout and names as the JAX package (nn/, ops/, tasks/,
runtime/, utils/), so each function has a counterpart of the same name
there. Plain tensor code is PyTorch; the Pallas kernels of the JAX package
are CUDA C++ kernels for Hopper (sm_90a) under csrc/, built at first use
(ops/cuda_build.py). The package imports torch and numpy only, never jax
and nothing of tf_gnn_samples_tpu.

Ported so far: all seven model families on all four tasks, QM9, PPI,
VarMisuse and the citation networks (train and test CLIs:
`python -m tf_gnn_samples_torch.train MODEL
{QM9,PPI,VarMisuse,cora,citeseer,pubmed}`,
`python -m tf_gnn_samples_torch.test CKPT [DATA]`); the parallel runtimes
are still to port.
"""

__version__ = "0.1.0"

SMALL_NUMBER = 1e-7
BIG_NUMBER = 1e7
