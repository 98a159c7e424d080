"""Typed configuration of the PyTorch port.

A copy of ``egomotion_with_local_loop_closures_tpu/config.py``
(``ELLCConfig`` and ``TEST_CONFIG``): the same fields, defaults and
methods, so that a configuration converts both ways with
``dataclasses.asdict``.  It is copied, not imported, so that the port and
``chip_smoke.py`` load nothing of the JAX package.  The field-by-field
provenance against the reference (``src/ExternVariable.h``) is documented
in the original; ``tests/test_torch_geom.py`` checks the two stay equal.

The port implements the exact form of every TPU-only layout switch, so it
reads none of these fields: ``use_window_warp``, ``warp_window``,
``warp_window_rematch``, ``warp_oow_fallback``, ``warp_valid_floor``,
``stereo_compact_frac``, ``stereo_short_steps``, ``stereo_short_frac``,
``stereo_pack_u8`` and ``use_pallas_reg``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ELLCConfig:
    """All tunables of the ELLC pipeline (see the module docstring)."""

    # image geometry
    rows: int = 270
    cols: int = 480
    fx: float = 1642.405612 / 4.0
    fy: float = 1636.148027 / 4.0
    cx: float = 480 / 2.0
    cy: float = 270 / 2.0
    num_levels: int = 4

    # undistortion
    do_undistortion: bool = False
    distortion: Tuple[float, float, float, float, float] = (
        -0.288283, 0.146546, 0.003800, -0.001690, -0.132134)

    # keyframing
    keyframe_interval: int = 8

    # Gauss-Newton tracking (index 0 = finest level)
    max_iters: Tuple[int, int, int, int] = (4, 7, 9, 12)
    max_iters_replay: Tuple[int, int, int, int] = (5, 1, 1, 1)
    termination_weights: Tuple[float, ...] = (
        1e5, 1e5, 1e5, 1e4, 1e4, 1e4)
    huber_d: float = 3.0
    camera_pixel_noise_2: float = 16.0

    # TPU warp strategy (not read by the port)
    use_window_warp: bool = True
    warp_window: Tuple[int, int, int, int] = (3, 3, 4, 8)
    warp_window_rematch: Tuple[int, int, int, int] = (6, 6, 8, 16)
    warp_oow_fallback: float = 0.25
    warp_valid_floor: float = 0.10

    # depth-map random init
    min_abs_grad_create: float = 1.0
    min_abs_grad_decrease: float = 5.0
    min_blacklist: int = -1
    var_random_init: float = 0.125
    bootstrap_rng: str = "jax"

    # epipolar line selection
    min_epl_grad_squared: float = 4.0
    min_epl_length_squared: float = 1.0
    min_epl_angle_squared: float = 0.09

    # line stereo
    min_depth: float = 0.05
    max_epl_length_crop: float = 30.0
    min_epl_length_crop: float = 3.0
    gradient_sample_dist: float = 1.0
    sample_point_to_border: float = 7.0
    max_error_stereo: float = 1300.0
    min_distance_error_stereo: float = 1.5
    stereo_epl_var_fac: float = 2.0
    division_eps: float = 1e-10
    stereo_max_steps: int = 36
    # TPU stereo layout (not read by the port)
    stereo_compact_frac: float = 0.14
    stereo_short_steps: int = 16
    stereo_short_frac: float = 0.04
    stereo_pack_u8: bool = True

    # depth filter / EKF
    camera_pixel_noise: float = 16.0
    validity_counter_initial_observe: float = 5.0
    succ_var_inc_fac: float = 1.01
    fail_var_inc_fac: float = 1.1
    max_var: float = 0.25
    diff_fac_observe: float = 1.0
    diff_fac_prop_merge: float = 1.0
    validity_counter_max: float = 5.0
    validity_counter_max_variable: float = 250.0
    validity_counter_dec: float = 5.0
    validity_counter_inc: float = 5.0
    max_diff_constant: float = 1600.0
    max_diff_grad_mult: float = 0.25
    lsd_correct_hole_fill: bool = False
    val_sum_min_for_create: float = 30.0
    val_sum_min_for_unblacklist: float = 100.0
    val_sum_min_for_keep: float = 24.0
    reg_dist_var: float = 0.075 * 0.075
    diff_fac_smoothing: float = 1.0

    # active-region borders
    border: int = 3

    # loop closure
    loop_window: int = 20
    match_threshold: float = 0.1
    min_match_difference: int = 8
    max_rel_view_angle: float = 10.0
    min_seeds_for_connection_lost: float = 0.0
    histogram_bins: int = 256
    restore_connection: bool = False
    min_wait_count: int = 0
    use_loop_closure_trigger: bool = False
    trigger_loop_closure_on: float = 20.0
    trigger_loop_closure_off: float = 1.0

    # rotation averaging (do_sim3_refine is not ported)
    ra_batch_size: int = 4
    ra_batch_size_bootstrap: int = 10
    ra_sigma_deg: float = 5.0
    ra_irls_max_iters: int = 100
    ra_irls_tol: float = 1e-3
    ra_l1_max_iters: int = 10
    do_sim3_refine: bool = False
    sim3_iters: int = 8

    # runtime
    max_frames: int = 32500
    dtype: str = "float32"
    use_pallas_reg: bool = False
    do_loop_closure: bool = False

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.cols)

    def level_shape(self, level: int) -> Tuple[int, int]:
        """Pyramid shape at ``level`` (floor division, Frame.cpp:287-293)."""
        return (self.rows >> level, self.cols >> level)

    def level_intrinsics(self, level: int) -> Tuple[float, float, float, float]:
        """Per-level (fx, fy, cx, cy); mirrors UserDefinedFunc.cpp:33-49."""
        s = float(2 ** level)
        return (self.fx / s, self.fy / s, self.cx / s, self.cy / s)

    def replace(self, **kw) -> "ELLCConfig":
        return dataclasses.replace(self, **kw)


TEST_CONFIG = ELLCConfig(
    rows=96,
    cols=128,
    fx=120.0,
    fy=120.0,
    cx=64.0,
    cy=48.0,
    stereo_max_steps=36,
)

# The settings under which the JAX package computes what the port computes:
# exact bilinear warps, the dense stereo walk, unpacked float samples and
# the bit-exact glibc bootstrap.
PARITY_OVERRIDES = dict(use_window_warp=False, stereo_compact_frac=0.0,
                        stereo_pack_u8=False, bootstrap_rng="glibc")
