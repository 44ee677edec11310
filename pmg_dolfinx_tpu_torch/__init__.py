"""pmg_dolfinx_tpu_torch — the PyTorch/CUDA port of `pmg_dolfinx_tpu`.

The same p-multigrid solver for ``-div(kappa grad u) = f`` on box and
curved-hex meshes, written on torch tensors instead of JAX arrays, with
the Pallas kernels of the Kronecker-sum and general-hex lattice operators
replaced by hand-written CUDA C++ kernels for Hopper
(`csrc/kron_blocked.cu`, `csrc/lattice_blocked.cu`). The JAX package stays the
reference: every module here keeps its counterpart's file name and
layout (`fem ops solvers models utils`) and is held against it by the
`tests/test_torch_*.py` parity tests.

This package never imports `jax` or `pmg_dolfinx_tpu`; the host-side
numpy setup code is copied, not imported.

Matmul precision follows the JAX package's ``precision="highest"``
contract: float32 products run in full float32 (no TF32), set here once
for every module of the package.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
