"""Configuration of the PyTorch port.

Field for field, with the same defaults, the frozen dataclasses of
``libviso_tpu/config.py`` (whose comments hold the measurements behind each
default).  The port carries no weights: configuration is what it takes
over, and ``from_jax_config`` rebuilds any of these classes from an
instance of its JAX counterpart so both packages run one configuration.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


def pad_axes(c, ndim: int):
    """A per-row calibration tensor with trailing singleton axes up to
    ``ndim`` axes; floats pass through."""
    if isinstance(c, torch.Tensor) and c.dim() < ndim:
        return c.reshape(*c.shape, *([1] * (ndim - c.dim())))
    return c


@dataclasses.dataclass(frozen=True)
class Calib:
    """Rectified stereo calibration: f = P1[0,0], cu = P1[0,2],
    cv = P1[1,2], base = |P2[0,3] / P2[0,0]|.

    The fields are Python floats, or float32 tensors that hold one value
    per row of a batch of problems (serving: one calibration per stream).
    The one layout for such tensors: their shape is that of the batch's
    leading axes, (S,) for S streams and () for the batch of none, with
    no trailing singleton axis; the function that uses them gives them
    the trailing axes of its operands (``against``).
    """

    f: float
    cu: float
    cv: float
    base: float

    def against(self, ndim: int) -> "Calib":
        """This calibration ready to broadcast against a tensor of ``ndim``
        axes whose leading axes are the batch's: tensor fields get trailing
        singleton axes, float fields pass through."""
        return Calib(*(pad_axes(c, ndim)
                       for c in (self.f, self.cu, self.cv, self.base)))

    def on(self, device) -> "Calib":
        """This calibration as float32 tensors on ``device`` (0-d tensors
        for float fields, made once per calibration and device).  The pose
        solve runs on these, so that a solo run and a row of a batch go
        through the same tensor-by-tensor arithmetic: dividing by a Python
        float is a multiplication by its reciprocal on the card, dividing
        by a tensor is not."""
        if isinstance(self.f, torch.Tensor):
            return Calib(*(c.to(device=device, dtype=torch.float32)
                           for c in (self.f, self.cu, self.cv, self.base)))
        return _scalar_calib(self, torch.device(device))

    @staticmethod
    def from_projections(P1, P2) -> "Calib":
        # float32, as the JAX package evaluates it
        P1 = np.asarray(P1, np.float32)
        P2 = np.asarray(P2, np.float32)
        return Calib(
            f=float(P1[0, 0]),
            cu=float(P1[0, 2]),
            cv=float(P1[1, 2]),
            base=float(abs(P2[0, 3] / P2[0, 0])),
        )


@functools.lru_cache(maxsize=64)
def _scalar_calib(calib: Calib, device) -> Calib:
    return Calib(*(torch.tensor(c, dtype=torch.float32, device=device)
                   for c in (calib.f, calib.cu, calib.cv, calib.base)))


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Harris binned detector + Sobel-patch descriptor configuration.

    Every ``descriptor_gather`` value runs the plain index gather: the JAX
    package's one-hot gathers are TPU matrix-unit forms of the same
    selection, bitwise equal to its ``'take'`` path.
    """

    max_features: int = 1200
    nbinx: int = 24
    nbiny: int = 5
    harris_k: float = 0.04
    block_size: int = 3
    aperture: int = 5
    descriptor_radius: int = 5
    num_slots: int = 1280
    descriptor_gather: str = "onehot"
    pyramid_levels: int = 1
    subpixel: bool = False
    sharpen_sigma: float = 0.0
    sharpen_amount: float = 4.0
    sharpen_auto: bool = False
    sharpen_trigger: float = 0.28
    nms_radius: int = 0

    def __post_init__(self):
        if self.descriptor_gather not in ("onehot", "onehot_i8", "take"):
            raise ValueError(
                f"descriptor_gather must be 'onehot', 'onehot_i8' or "
                f"'take', got {self.descriptor_gather!r}")
        if self.descriptor_gather == "onehot_i8" and (
                self.sharpen_sigma > 0 or self.pyramid_levels > 1):
            raise ValueError(
                "descriptor_gather='onehot_i8' requires integer-valued "
                "images; sharpen_sigma>0 / pyramid_levels>1 break that")
        if self.sharpen_sigma < 0:
            raise ValueError("sharpen_sigma must be >= 0")
        if self.sharpen_auto and self.sharpen_sigma <= 0:
            raise ValueError("sharpen_auto needs sharpen_sigma > 0")

    @property
    def corners_per_bin(self) -> int:
        return self.max_features // (self.nbinx * self.nbiny)

    @property
    def descriptor_dim(self) -> int:
        d = 2 * self.descriptor_radius + 1
        return d * d

    @property
    def descriptor_dim_padded(self) -> int:
        """Descriptor length padded to a multiple of 128."""
        return ((self.descriptor_dim + 127) // 128) * 128


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Descriptor matcher configuration (radius, Sampson and ratio gates,
    metric 'l2' by default, 'l1' for strict reference parity)."""

    radius: float = 80.0
    banded: bool = False
    use_epipolar: bool = False
    sampson_thresh: float = 1.0
    use_ratio: bool = False
    ratio: float = 0.9
    metric: str = "l2"

    @staticmethod
    def stereo() -> "MatchConfig":
        """LR match: epipolar-gated, no ratio test."""
        return MatchConfig(use_epipolar=True, sampson_thresh=1.0,
                           use_ratio=False, ratio=0.8, radius=80.0)

    @staticmethod
    def temporal() -> "MatchConfig":
        """Frame-to-frame match: ratio .9, no epipolar gate."""
        return MatchConfig(use_epipolar=False, use_ratio=True, ratio=0.9,
                           radius=80.0)


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """RANSAC + Gauss-Newton configuration."""

    num_hypotheses: int = 32
    gn_iters: int = 100
    fit_gn_iters: int = 30
    hypothesis_method: str = "procrustes"
    procrustes_polish_iters: int = 3
    # masked GN steps between two convergence checks (one host sync each);
    # results do not depend on it: converged lanes freeze under the mask
    gn_unroll: int = 2
    inlier_threshold: float = 2.0
    converge_thresh: float = 1e-4
    min_inliers: int = 6
    model_size: int = 3
    gn_lm_lambda: float = 0.0

    def __post_init__(self):
        if self.hypothesis_method not in ("gn", "procrustes"):
            raise ValueError(
                f"hypothesis_method must be 'gn' or 'procrustes', got "
                f"{self.hypothesis_method!r}")
        if self.gn_unroll < 1:
            raise ValueError(
                f"gn_unroll must be >= 1 (got {self.gn_unroll})")


@dataclasses.dataclass(frozen=True)
class MonoConfig:
    """Monocular estimator configuration (``pipeline/mono.py``): RANSAC
    threshold and solver ('5pt' or '8pt', and the first pass's), the
    hypothesis selection ('msac' or 'magsac') and refit weights, the pose
    polish, and the relative-scale propagation with its estimator
    ('bundle', 'regression', 'median' or 'pnp')."""

    sampson_thresh: float = 2e-5
    min_good: int = 10
    rematch_ratio: float = 0.9
    num_hypotheses: int = 0
    method: str = "5pt"
    first_pass: str = "same"
    scoring: str = "magsac"
    soft_refit: bool = True
    refine_iters: int = 8
    scale_propagation: bool = True
    min_scale_support: int = 12
    parallax_keep_frac: float = 0.5
    scale_estimator: str = "bundle"
    pnp_iters: int = 10
    bundle_iters: int = 10

    def __post_init__(self):
        if self.method not in ("5pt", "8pt"):
            raise ValueError(
                f"method must be '5pt' or '8pt', got {self.method!r}")
        if self.first_pass not in ("same", "8pt"):
            raise ValueError(
                f"first_pass must be 'same' or '8pt', got "
                f"{self.first_pass!r}")
        if self.scoring not in ("msac", "magsac"):
            raise ValueError(
                f"scoring must be 'msac' or 'magsac', got {self.scoring!r}")
        if self.scale_estimator not in ("bundle", "regression", "median",
                                        "pnp"):
            raise ValueError(
                "scale_estimator must be bundle|regression|median|pnp, "
                f"got {self.scale_estimator!r}")

    def resolved_hypotheses(self) -> int:
        """RANSAC samples: ``num_hypotheses``, or when 0 the default of
        the method (64 for '5pt', each sample scoring up to 22 models;
        128 for '8pt')."""
        if self.num_hypotheses > 0:
            return self.num_hypotheses
        return 64 if self.method == "5pt" else 128


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Sliding-window bundle-adjustment configuration
    (``pipeline/windowed.py``): window and stride in frames, LM iterations,
    the two observation gates [px], the cross-window and VO-anchor prior
    strengths, the observations a camera needs for its refined motion, and
    the acceptance gate (``pipeline/refine.py::holdout_gate``)."""

    window: int = 8
    stride: int = 4
    iters: int = 10
    outlier_px: float = 30.0
    rerank_px: float = 2.0
    prior_strength: float = 1.0
    vo_prior_strength: float = 0.0
    min_cam_obs: int = 24
    gate: bool = True
    holdout_modulus: int = 0
    gate_margin: float = 0.90

    def __post_init__(self):
        if self.stride > self.window:
            raise ValueError(
                f"stride ({self.stride}) must be <= window "
                f"({self.window}): larger strides leave frames covered "
                "by no BA window")
        if self.holdout_modulus < 0:
            raise ValueError("holdout_modulus must be >= 0")


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Run-level health-alarm thresholds."""

    support_ratio_alarm: float = 0.72
    motion_jump_alarm: float = 0.3


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level stereo odometry pipeline configuration."""

    detector: DetectorConfig = DetectorConfig()
    stereo_match: MatchConfig = MatchConfig.stereo()
    temporal_match: MatchConfig = MatchConfig.temporal()
    ransac: RansacConfig = RansacConfig()
    min_circle_matches: int = 3
    dtype: str = "float32"
    keep_features_on_failure: bool = False
    max_keep_age: int = 3

    def __post_init__(self):
        if self.keep_features_on_failure and self.max_keep_age < 1:
            raise ValueError("max_keep_age must be >= 1")

    def with_metric(self, metric: str) -> "PipelineConfig":
        """Return a copy with both matchers switched to ``metric``."""
        return dataclasses.replace(
            self,
            stereo_match=dataclasses.replace(self.stereo_match,
                                             metric=metric),
            temporal_match=dataclasses.replace(self.temporal_match,
                                               metric=metric),
        )

    @staticmethod
    def mono() -> "PipelineConfig":
        """Monocular SfM defaults."""
        return PipelineConfig(
            detector=DetectorConfig(max_features=1500, descriptor_radius=9,
                                    num_slots=1536),
            stereo_match=MatchConfig(radius=10.0, use_epipolar=True,
                                     sampson_thresh=1.0, use_ratio=True,
                                     ratio=0.9),
            temporal_match=MatchConfig(radius=10.0),
        )


CONFIG_CLASSES = {cls.__name__: cls for cls in (
    Calib, DetectorConfig, MatchConfig, RansacConfig, MonoConfig, BAConfig,
    HealthConfig, PipelineConfig)}


def _from_dict(cls, values: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = values[f.name]
        if dataclasses.is_dataclass(f.default) and isinstance(v, dict):
            v = _from_dict(type(f.default), v)
        kwargs[f.name] = v
    return cls(**kwargs)


def from_jax_config(obj):
    """Rebuild a JAX-package config dataclass as its port counterpart.

    Takes the values from ``dataclasses.asdict(obj)``; nested configs
    (``PipelineConfig.detector`` etc.) are rebuilt recursively.
    """
    cls = CONFIG_CLASSES[type(obj).__name__]
    return _from_dict(cls, dataclasses.asdict(obj))
