"""PyTorch/CUDA port of the jepsen_tpu checker.

This package sits beside ``jepsen_tpu`` (the JAX reference) and imports
nothing from it: the host layers it needs are its own copies. It holds
the WGL linearizability search for the ``cas-register`` / ``register``
models, for one history (``ops.wgl.check_history``) or a batch
(``parallel.check_batch``, and the keyed ``independent.checker(
checker.linearizable(...))`` on top of it). The BFS level program runs as
hand-written CUDA kernels for Hopper on a member axis
(``csrc/wgl_level.cu``, the single search being the batch of one), with a
plain PyTorch version of every stage beside them (``ops.wgl_level``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
