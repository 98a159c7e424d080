"""ELLC on PyTorch: the port of ``egomotion_with_local_loop_closures_tpu``
to PyTorch and CUDA on an NVIDIA H100.

The subpackages mirror the JAX package's layout and function names, so
each function's counterpart is found under the same path:

- ``geom``:    se(3)/SO(3) Lie ops, the pinhole camera, the 6x6 solve.
- ``image``:   image pyramids, gradients, bilinear sampling.
- ``track``:   multi-scale Gauss-Newton direct image alignment.
- ``depth``:   inverse-depth filter (epipolar stereo, EKF, propagation,
  hole filling and regularization).
- ``loop``:    local loop closure: histograms and the keyframe window.
- ``graph``:   rotation averaging and the per-batch pose correction.
- ``ops``:     hand-written CUDA kernels with their bindings
  (sources under ``csrc/``).
- ``runtime``: the frame-loop pipeline, the sequence runner, LC mode
  (``ellc_lc``), pose IO and the CLI.
- ``convert``: moves pipeline states between the JAX package and the port.

The port imports ``torch`` and ``numpy``, never ``jax``.
"""

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig

__version__ = "0.1.0"

__all__ = ["ELLCConfig", "__version__"]
