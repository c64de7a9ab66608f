"""repro_torch — the msGeMM system in PyTorch, with a hand-written CUDA
msGeMM kernel for Hopper (sm_90a).

The package mirrors the module layout of the JAX package ``repro`` one to
one, so each module here has one reference module there.  It imports
``torch`` and numpy only; the JAX package is the reference that the tests
compare against, never a dependency.

Entry points run on the GPU unless the caller passes ``device="cpu"``
(see :func:`repro_torch.device.resolve`).  On CPU tensors every kernel
wrapper takes its plain PyTorch version; on CUDA tensors it launches the
kernel or raises.
"""
