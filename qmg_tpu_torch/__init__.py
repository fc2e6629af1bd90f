"""qmg_tpu_torch: the PyTorch/CUDA port of qmg_tpu.

Each module shares its name with its counterpart in ``qmg_tpu`` and keeps
the same field layout ``(2, Y, X/2, nc)`` (complex tensors), so the two
packages are compared array for array. The port covers the n13 flagship
K-cycle solve: U(1) gauge field -> Wilson2D -> BiCGstab(l) null vectors,
chiral doubling, block-orthonormal transfers, Galerkin coarse operators,
dense coarsest inverse -> outer flexible GCR around the K-cycle. The
coarsest level can instead be solved by CG on its normal operator,
deflated by its lowest eigenpairs (``eig``, ``deflate_coarsest``); around
the solve the port keeps hierarchy checkpoints in qmg_tpu's file format
(``checkpoint``) and complex128 refinement of a complex64 solve
(``refine``, ``solve.make_refined_solver``).

Inside the K-cycle the stencil applies run through hand-written CUDA
kernels: the Wilson Dslash kernels (``csrc/wilson.cu``, wrappers
``wilson_kernel.py``) and the generic stencil kernels (``csrc/dslash.cu``,
wrappers ``dslash_kernel.py``); every other operation is plain PyTorch.
The fine level can be cut into blocks over a mesh held in one process or
spread over ``torch.distributed`` ranks (``parallel.py``,
``shard_dslash.py``). The package imports no JAX.
"""

from .lattice import Lattice2D  # noqa: F401

__all__ = ["Lattice2D"]
