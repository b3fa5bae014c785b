"""PyTorch / CUDA port of the Frenzy reproduction.

The model side serves and trains the JAX package's configs on one NVIDIA
H100 through hand-written Hopper kernels (``kernels/csrc/*.cu``); the
control plane (``core``: MARP, HAS, the lifecycle engine and the
serverless API; ``cluster``: the simulator and its schedulers; ``obs``)
is the JAX package's, decision for decision, and places jobs on the
port's device catalog, which holds the H100 too.  It imports torch and
never JAX or the JAX package ``repro``; its subpackages mirror that
package's names.
"""
