"""ELLC on PyTorch: the port of ``egomotion_with_local_loop_closures_tpu``
to PyTorch and CUDA on an NVIDIA H100.

The subpackages mirror the JAX package's layout and function names, so
each function's counterpart is found under the same path:

- ``geom``:    se(3)/SO(3) Lie ops, the pinhole camera, the 6x6 solve.
- ``image``:   image pyramids, gradients, bilinear sampling.
- ``track``:   multi-scale Gauss-Newton direct image alignment.
- ``depth``:   inverse-depth filter (epipolar stereo, EKF, propagation,
  hole filling and regularization).
- ``loop``:    local loop closure (histograms, the keyframe window) and
  connection recovery.
- ``graph``:   rotation averaging, the per-batch pose correction and the
  Sim(3) pose-graph refinement.
- ``ops``:     hand-written CUDA kernels with their bindings
  (sources under ``csrc/``).
- ``parallel``: several videos on one card, the process group and
  device mesh, and the pixel-sharded Gauss-Newton step.
- ``runtime``: the frame-loop pipeline, the sequence runner, LC mode
  (``ellc_lc``), checkpoints, pose IO, the frame sources (video, image
  directory, the native C++ loader under ``native/``) and the CLI.
- ``utils``:   accuracy metrics, timing and tracing, synthetic scenes,
  debug images, the memory footprint and the glibc draws.
- ``convert``: moves pipeline states between the JAX package and the port.

The port imports ``torch`` and ``numpy``, never ``jax``.
"""

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig

__version__ = "0.1.0"

__all__ = ["ELLCConfig", "__version__"]
