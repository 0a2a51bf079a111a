"""Configuration tree of the PyTorch port (a copy of streamingflow_tpu/config.py).

The keys, values and defaults are those of the JAX package, so a config
written for one loads in the other.  PyYAML is imported only by the
functions that read YAML, so importing the package does not need it.

A dataclass mirror of the reference yacs/fvcore config
(reference: streamingflow/config.py:32-211), with the same key names and
defaults so that the shipped YAML configs (e.g. Prediction_LC_ODE_Variable.yml)
merge cleanly.  Unlike the reference we keep the tree immutable-by-convention
and provide explicit YAML / dotted-key merge helpers instead of CfgNode.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


def _cfg(cls):
    """Decorator: dataclass with keyword-only defaults."""
    return dataclass(cls)


@_cfg
class PretrainedConfig:
    LOAD_WEIGHTS: bool = False
    PATH: str = ''


@_cfg
class DatasetConfig:
    DATAROOT: str = 'data/nuscenes'
    VERSION: str = 'trainval'
    NAME: str = 'nuscenes'
    MAP_FOLDER: str = 'data/nuscenes'
    IGNORE_INDEX: int = 255
    FILTER_INVISIBLE_VEHICLES: bool = True
    SAVE_DIR: str = 'datas'
    USE_MULTISWEEP: bool = False
    # sweeps per keyframe interval for multisweep labels (20 Hz lidar over
    # 0.5 s keyframes -> 10; reference hard-codes nsweeps=10,
    # NuscenesData.py:327)
    MULTISWEEP_NSWEEPS: int = 10
    FRAME_SKIP: int = 4


@_cfg
class ImageConfig:
    FINAL_DIM: Tuple[int, int] = (224, 480)
    RESIZE_SCALE: float = 0.3
    TOP_CROP: int = 46
    ORIGINAL_HEIGHT: int = 900
    ORIGINAL_WIDTH: int = 1600
    NAMES: List[str] = field(default_factory=lambda: [
        'CAM_FRONT_LEFT', 'CAM_FRONT', 'CAM_FRONT_RIGHT',
        'CAM_BACK_LEFT', 'CAM_BACK', 'CAM_BACK_RIGHT'])


@_cfg
class LiftConfig:
    # image-to-BEV lifting bounds: [min, max, step]
    X_BOUND: List[float] = field(default_factory=lambda: [-50.0, 50.0, 0.5])
    Y_BOUND: List[float] = field(default_factory=lambda: [-50.0, 50.0, 0.5])
    Z_BOUND: List[float] = field(default_factory=lambda: [-10.0, 10.0, 20.0])
    D_BOUND: List[float] = field(default_factory=lambda: [2.0, 50.0, 1.0])
    RANGE: List[float] = field(default_factory=lambda: [-50, -50, -5.0, 50, 50, 3.0])
    GT_DEPTH: bool = True
    GEN_DEPTH: bool = False
    DISCOUNT: float = 0.5


@_cfg
class GenConfig:
    GEN_DEPTH: bool = False
    GEN_RANGE: bool = False
    GEN_VOXELS: bool = False


@_cfg
class EgoConfig:
    WIDTH: float = 1.85
    HEIGHT: float = 4.084


@_cfg
class ModalityConfig:
    USE_LIDAR: bool = True
    USE_RADAR: bool = False
    USE_CAMERA: bool = False


@_cfg
class LidarModelConfig:
    USE_STPN: bool = False
    USE_BESTI: bool = False
    USE_RANGE: bool = False
    USE_ALL_POINTS: bool = False
    HEIGHT_FEAT_SIZE: int = 13
    # 'pillar8x' (dense, TPU-first default) or 'spconv8x' (exact sparse
    # engine, reference-parity path)
    BACKBONE: str = 'pillar8x'
    # 1x1-project the 256-ch BEV features to the temporal width before the
    # temporal blocks: the reference feeds 256 channels into the first
    # TemporalBlock (temporal_model.py:29-34), which makes the lidar
    # temporal model the most HBM-heavy stage on TPU; pre-reduction cuts
    # that traffic ~4x.  Off for strict reference channel flow.
    PRE_REDUCE_TEMPORAL: bool = True
    # Loader contract: point groups arrive bucket-grouped by BEV bin tile
    # (native.tile_sort_points, O(P) counting sort in the loader workers),
    # letting the Pallas binning kernel skip its device-side sort.  The
    # nuScenes/Lyft readers and the synthetic batcher honour this flag.
    TILE_SORTED_POINTS: bool = True


@_cfg
class SmallEncoderConfig:
    FILTER_SIZE: int = 64
    SKIPCO: bool = False


@_cfg
class VoxelConfig:
    VOXEL_SIZE: Tuple[float, float, float] = (0.5, 0.5, 0.4)
    AREA_EXTENTS: List[List[float]] = field(
        default_factory=lambda: [[-50., 50.], [-50., 50.], [-3, 2]])


@_cfg
class EncoderConfig:
    DOWNSAMPLE: int = 8
    NAME: str = 'efficientnet-b4'
    OUT_CHANNELS: int = 64
    USE_DEPTH_DISTRIBUTION: bool = True


@_cfg
class TemporalModelConfig:
    NAME: str = 'temporal_block'
    START_OUT_CHANNELS: int = 64
    EXTRA_IN_CHANNELS: int = 0
    INBETWEEN_LAYERS: int = 0
    PYRAMID_POOLING: bool = True
    INPUT_EGOPOSE: bool = True


@_cfg
class DistributionConfig:
    LATENT_DIM: int = 64
    MIN_LOG_SIGMA: float = -5.0
    MAX_LOG_SIGMA: float = 5.0


@_cfg
class FuturePredConfig:
    N_GRU_BLOCKS: int = 2
    N_RES_LAYERS: int = 1
    MIXTURE: bool = True
    DELTA_T: float = 0.05
    USE_VARIABLE_ODE_STEP: bool = False
    # TPU-specific: static upper bound (seconds) on a single observation/target
    # gap in fixed-step mode; sets the unrolled sub-step count of the scan tape.
    MAX_GAP_SECONDS: float = 0.6


@_cfg
class SparseEncoderConfig:
    """TPU sparse LiDAR encoder ("spconv8x" equivalent).

    Mirrors the hard-wired dict at reference streamingflow/models/streamingflow.py:118.
    The *_CAP fields are TPU-specific static capacities for the padded sparse
    representation at each stride stage.
    """
    IN_CHANNELS: int = 5
    SPARSE_SHAPE: Tuple[int, int, int] = (1600, 1600, 41)  # (x, y, z) grid
    OUTPUT_CHANNELS: int = 128
    ENCODER_CHANNELS: List[List[int]] = field(default_factory=lambda: [
        [16, 16, 32], [32, 32, 64], [64, 64, 128], [128, 128]])
    BASE_CHANNELS: int = 16
    POINT_CLOUD_RANGE: List[float] = field(
        default_factory=lambda: [-50.0, -50.0, -5.0, 50.0, 50.0, 3.0])
    VOXEL_SIZE: List[float] = field(default_factory=lambda: [0.0625, 0.0625, 0.2])
    MAX_NUM_POINTS: int = 10
    MAX_VOXELS: int = 120000
    # Static active-site capacity per stage (post-stride), TPU padding
    # caps.  Stride-2 site generation DILATES the active set (every
    # input touches up to 8 output cells), so stages 2-3 need MORE slots
    # than stage 1; sized for realistic multisweep clouds with ~15%
    # headroom (measured: 70k/146k/132k/65k — tools/size_caps.py).
    STAGE_CAPS: List[int] = field(
        default_factory=lambda: [120000, 170000, 150000, 75000])
    # submanifold-conv execution backend: 'column' keeps (x, y)-sparse
    # columns with a dense z axis in a z-fused (V_col, nz*C) layout — one
    # wide 9-tap gather + dense z conv per conv (ops/sparse_columns.py,
    # the flagship-scale TPU path); 'tiled' batches the 27-tap
    # neighbourhood into dense convs over occupied 8x8x8 tiles
    # (ops/sparse_tiled.py); 'gather' is the row-gather GEMM engine
    # (ops/sparse.py).  Numerics agree to summation order.
    ENGINE: str = 'column'
    # static active-column capacity per stage for the column engine;
    # stride-2 site generation DILATES the column set before the coarser
    # grid re-merges it, so stage 2 needs MORE columns than stage 1.
    # Sized for realistic multisweep clouds with ~15% headroom (measured
    # worst case 56k/75k/59k/29k — tools/size_caps.py).
    COLUMN_CAPS: List[int] = field(
        default_factory=lambda: [65536, 86016, 69632, 34816])
    # z-axis conv formulation for the column engine: 'sep' (dx=0 taps as
    # sorted-order slices, 6 gathers instead of 8 — default), 'banded'
    # (9-tap gather + fused matmuls, zero relayouts), or 'conv' (9-tap
    # gather + lax.conv over z, minimal FLOPs, pays tap-stack
    # transposes), or 'winfuse' (fused Pallas kernel: block-contiguous
    # window DMA + in-VMEM one-hot selection + banded matmuls — tap
    # stacks never round-trip HBM; ops/pallas_winfuse.py).
    # A/B per hardware: tools/exp_column_pieces.py.
    Z_FORMULATION: str = 'sep'
    # 'winfuse' window rows per dx slice (>= WINDOW_BLOCK + 16; measured
    # per-block spans stay < 304 at block 256, tools/exp_window_stats.py;
    # >=320 overflows the 16M scoped VMEM at stage-1 shapes with the
    # required fp32 matmul accumulator)
    WINFUSE_WINDOW: int = 304
    # 'win' formulation geometry: sorted ids make per-tap sources
    # MONOTONE, so WINDOW_BLOCK consecutive columns read one contiguous
    # WINDOW_WIDTH-row slice per dx (measured widths stay < 304 at
    # block 256 on LiDAR-like clouds, tools/exp_window_stats.py); blocks
    # whose window overflows fall back to direct gathers, whole-block,
    # capped at WINDOW_RESID_BLOCKS (beyond it side taps drop, counted —
    # static-cap semantics, docs/PARITY.md).
    WINDOW_BLOCK: int = 256
    WINDOW_WIDTH: int = 512
    WINDOW_RESID_BLOCKS: int = 16
    # column engine only: stages >= this index (1-based; 5 = conv_out
    # only) leave the column representation and run DENSE grid convs —
    # on the post-downsample grids (400^2 x 11 at stage 3) computing
    # every cell on the MXU beats gathering active sites (A/B in
    # docs/PERF.md).  0 disables.  Numerics identical (masked BN zeroes
    # inactive cells, so dense convs reproduce subm active-site values);
    # stages 1-2 grids are too large to densify (HBM).
    DENSE_TAIL_FROM_STAGE: int = 3
    # static occupied-tile capacity per stage for the tiled engine
    # (measured worst case 20.3k/10.3k/3.5k/0.7k — tools/size_caps.py)
    TILE_CAPS: List[int] = field(
        default_factory=lambda: [28672, 14336, 6144, 1536])
    # tile edge lengths (x, y, z) for the tiled engine; each dim must be
    # divisible by the conv strides (2).  Smaller tiles waste fewer FLOPs
    # on empty cells but need more tile slots; tune per hardware.
    TILE_SHAPE: Tuple[int, int, int] = (8, 8, 8)
    # rematerialise each ladder block (subm conv / basic block / strided
    # down) individually: the backward recomputes one block's tap stacks
    # and activations at a time instead of holding the whole 4-stage x
    # 5-cloud ladder live (whole-ladder backward needs 84G vs 15.75G HBM
    # on v5e at flagship scale — docs/PERF.md round 5).  Free for
    # inference (forward-only jit computes each block once).
    REMAT_LADDER: bool = True
    # LiDAR-branch compute dtype: 'auto' follows the points dtype;
    # 'bfloat16' runs the conv ladder in bf16 while POINTS STAY fp32 (voxel
    # quantisation is precision-sensitive: bf16 ulp at 54 m range exceeds
    # the 0.0625 m voxel size).  Mixed-precision runs set 'bfloat16' here
    # instead of casting the point cloud.
    COMPUTE_DTYPE: str = 'auto'


@_cfg
class ModelConfig:
    USE_TRANSFORMER: bool = False
    USE_GRU_ODE: bool = False
    USE_HYBRID_ODE: bool = False
    SOLVER: str = 'euler'
    IMPUTE: bool = False
    STEP_DELTA_T: float = 0.05
    BN_MOMENTUM: float = 0.1
    # camera lift-splat pooling: 'scatter' (XLA segment-sum, fp32-exact
    # default), 'sorted' (bit-exact reference order), or 'pallas_patch'
    # (structural MXU kernel, ops/pallas_patch_pool.py — the fast TPU path)
    BEV_POOL_BACKEND: str = 'scatter'
    # rematerialise the big sub-modules (camera encoder, LiDAR ladder,
    # temporal models, future prediction, decoder) under jax.checkpoint so
    # the flagship train step fits one chip's HBM (the reference trains this
    # config at 1 sample/GPU fp16, train.py:76-94; without remat the
    # backward needs 17.3G vs 15.75G on v5e).  Free for inference: a
    # forward-only jit computes each block exactly once.
    REMAT: bool = True
    MODALITY: ModalityConfig = field(default_factory=ModalityConfig)
    LIDAR: LidarModelConfig = field(default_factory=LidarModelConfig)
    SMALL_ENCODER: SmallEncoderConfig = field(default_factory=SmallEncoderConfig)
    ENCODER: EncoderConfig = field(default_factory=EncoderConfig)
    TEMPORAL_MODEL: TemporalModelConfig = field(default_factory=TemporalModelConfig)
    DISTRIBUTION: DistributionConfig = field(default_factory=DistributionConfig)
    FUTURE_PRED: FuturePredConfig = field(default_factory=FuturePredConfig)
    SPARSE_ENCODER: SparseEncoderConfig = field(default_factory=SparseEncoderConfig)


@_cfg
class VehicleSegConfig:
    WEIGHTS: List[float] = field(default_factory=lambda: [1.0, 2.0])
    USE_TOP_K: bool = True
    TOP_K_RATIO: float = 0.25


@_cfg
class PedestrianSegConfig:
    ENABLED: bool = True
    WEIGHTS: List[float] = field(default_factory=lambda: [1.0, 10.0])
    USE_TOP_K: bool = True
    TOP_K_RATIO: float = 0.25


@_cfg
class HDMapConfig:
    ENABLED: bool = True
    ELEMENTS: List[str] = field(default_factory=lambda: ['lane_divider', 'drivable_area'])
    WEIGHTS: List[List[float]] = field(default_factory=lambda: [[1.0, 5.0], [1.0, 1.0]])
    TRAIN_WEIGHT: List[float] = field(default_factory=lambda: [1, 1])
    USE_TOP_K: List[bool] = field(default_factory=lambda: [True, False])
    TOP_K_RATIO: List[float] = field(default_factory=lambda: [0.25, 0.25])


@_cfg
class SemanticSegConfig:
    VEHICLE: VehicleSegConfig = field(default_factory=VehicleSegConfig)
    PEDESTRIAN: PedestrianSegConfig = field(default_factory=PedestrianSegConfig)
    HDMAP: HDMapConfig = field(default_factory=HDMapConfig)


@_cfg
class InstanceSegConfig:
    ENABLED: bool = True


@_cfg
class InstanceFlowConfig:
    ENABLED: bool = True


@_cfg
class ProbabilisticConfig:
    ENABLED: bool = True
    METHOD: str = 'GAUSSIAN'  # [BERNOULLI, GAUSSIAN, MIXGAUSSIAN]


@_cfg
class PlanningConfig:
    ENABLED: bool = True
    GRU_STATE_SIZE: int = 64
    SAMPLE_NUM: int = 600
    COMMAND: List[str] = field(default_factory=lambda: ['LEFT', 'FORWARD', 'RIGHT'])


@_cfg
class OptimizerConfig:
    LR: float = 3e-4
    WEIGHT_DECAY: float = 1e-7


@_cfg
class CostFunctionConfig:
    SAFETY: float = 0.1
    LAMBDA: float = 1.
    HEADWAY: float = 1.
    LRDIVIDER: float = 10.
    COMFORT: float = 0.1
    PROGRESS: float = 0.5
    VOLUME: float = 100.


@_cfg
class Config:
    LOG_DIR: str = 'logs'
    TAG: str = 'default'
    GPUS: List[int] = field(default_factory=lambda: [0])
    PRECISION: int = 32
    BATCHSIZE: int = 3
    EPOCHS: int = 20
    N_WORKERS: int = 5
    VIS_INTERVAL: int = 5000
    LOGGING_INTERVAL: int = 500
    TIME_RECEPTIVE_FIELD: int = 3
    N_FUTURE_FRAMES: int = 4
    FUTURE_DISCOUNT: float = 0.95
    GRAD_NORM_CLIP: float = 5
    PRETRAINED: PretrainedConfig = field(default_factory=PretrainedConfig)
    DATASET: DatasetConfig = field(default_factory=DatasetConfig)
    IMAGE: ImageConfig = field(default_factory=ImageConfig)
    LIFT: LiftConfig = field(default_factory=LiftConfig)
    GEN: GenConfig = field(default_factory=GenConfig)
    EGO: EgoConfig = field(default_factory=EgoConfig)
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    SEMANTIC_SEG: SemanticSegConfig = field(default_factory=SemanticSegConfig)
    INSTANCE_SEG: InstanceSegConfig = field(default_factory=InstanceSegConfig)
    INSTANCE_FLOW: InstanceFlowConfig = field(default_factory=InstanceFlowConfig)
    PROBABILISTIC: ProbabilisticConfig = field(default_factory=ProbabilisticConfig)
    PLANNING: PlanningConfig = field(default_factory=PlanningConfig)
    OPTIMIZER: OptimizerConfig = field(default_factory=OptimizerConfig)
    COST_FUNCTION: CostFunctionConfig = field(default_factory=CostFunctionConfig)

    # ------------------------------------------------------------------ merge
    def merge_dict(self, d: dict) -> 'Config':
        """Return a new Config with the (possibly nested) dict merged in."""
        out = copy.deepcopy(self)
        _merge_into(out, d)
        return out

    def merge_opts(self, opts: List[str]) -> 'Config':
        """Merge a flat [KEY, VALUE, KEY, VALUE, ...] list of dotted keys
        (reference config.py:236 merge_from_list semantics)."""
        if not opts:
            return self
        assert len(opts) % 2 == 0, f'odd number of override opts: {opts}'
        out = copy.deepcopy(self)
        for key, val in zip(opts[::2], opts[1::2]):
            node = out
            parts = key.split('.')
            for p in parts[:-1]:
                node = getattr(node, p)
            cur = getattr(node, parts[-1])
            setattr(node, parts[-1], _coerce(val, cur))
        return out

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _merge_into(node: Any, d: dict) -> None:
    for k, v in d.items():
        if not hasattr(node, k):
            raise KeyError(f'Unknown config key: {k}')
        cur = getattr(node, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _merge_into(cur, v)
        else:
            if isinstance(cur, tuple) and isinstance(v, list):
                v = tuple(v)
            if isinstance(cur, float) and isinstance(v, str):
                # YAML 1.1 reads '2e-4' (no dot) as a string: the shipped
                # configs/prediction_lc_ode_variable.yml's OPTIMIZER.LR
                v = float(v)
            setattr(node, k, v)


def _coerce(val: str, like: Any) -> Any:
    """Coerce a CLI string to the type of the existing config value."""
    if isinstance(like, bool):
        return str(val).lower() in ('1', 'true', 'yes', 'on')
    if isinstance(like, int):
        return int(val)
    if isinstance(like, float):
        return float(val)
    if isinstance(like, (list, tuple)):
        import yaml
        parsed = yaml.safe_load(val)
        return type(like)(parsed)
    return val


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='StreamingFlow (PyTorch port)')
    parser.add_argument('--config-file', default='', metavar='FILE',
                        help='path to config file')
    parser.add_argument('opts', default=None, nargs=argparse.REMAINDER,
                        help='Modify config options from the command line')
    return parser


def get_cfg(args=None, cfg_dict: Optional[dict] = None) -> Config:
    """Defaults -> cfg_dict -> YAML file -> CLI opts (reference config.py:222-238)."""
    cfg = Config()
    if cfg_dict is not None:
        cfg = cfg.merge_dict(cfg_dict)
    if args is not None:
        if getattr(args, 'config_file', ''):
            import yaml
            with open(args.config_file) as f:
                cfg = cfg.merge_dict(yaml.safe_load(f) or {})
        cfg = cfg.merge_opts(list(args.opts or []))
    return cfg


def load_cfg(path: str) -> Config:
    import yaml
    with open(path) as f:
        return Config().merge_dict(yaml.safe_load(f) or {})
