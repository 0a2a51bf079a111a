"""StreamingFlow: asynchronous camera + LiDAR streams -> BEV futures.

Port of streamingflow_tpu/models/streamingflow.py.  Inputs and outputs are
channels-last as in the JAX package (images (B, T, N, H, W, 3), points
(B, T_l, P, 5), outputs (B, T, H, W, K)); inside, the modules run NCHW.
Submodule names follow the flax variable paths (convert.py loads JAX weights
by them).

:func:`build_model` is the entry point: it builds the model on the card
unless asked for the CPU.  In train mode (``model.train()``) BatchNorm takes
batch statistics and moves its running ones, dropout and drop-connect draw
from the forward's ``generator``, and MODEL.REMAT recomputes the major
sub-modules in the backward pass (layers/trainmode.py).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .. import geometry as G
from ..config import Config
from ..device import resolve_device
from ..layers.conv import conv2d
from ..layers.trainmode import remat, set_generator
from ..ops.lift_splat import projection_to_birds_eye_view
from .decoder import Decoder
from .distributions import DistributionModule, distribution_forward
from .encoder import Encoder
from .future_prediction import FuturePredictionODE
from .lidar_encoder import LidarBEVEncoder
from .pillar_encoder import PillarBEVEncoder
from .planning import Planning
from .temporal_model import TemporalModel, TemporalModelIdentity


class StreamingFlow(nn.Module):

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self._generator: Optional[torch.Generator] = None
        (self.bev_resolution, self.bev_start_position,
         self.bev_dimension) = G.calculate_birds_eye_view_parameters(
            cfg.LIFT.X_BOUND, cfg.LIFT.Y_BOUND, cfg.LIFT.Z_BOUND)
        self.frustum = G.create_frustum(
            cfg.IMAGE.FINAL_DIM, cfg.MODEL.ENCODER.DOWNSAMPLE,
            cfg.LIFT.D_BOUND)
        self.depth_channels = self.frustum.shape[0]
        self.receptive_field = cfg.TIME_RECEPTIVE_FIELD
        self.n_future = cfg.N_FUTURE_FRAMES
        self.use_camera = cfg.MODEL.MODALITY.USE_CAMERA
        self.use_lidar = cfg.MODEL.MODALITY.USE_LIDAR
        bev_size = (int(self.bev_dimension[0]), int(self.bev_dimension[1]))
        tm = cfg.MODEL.TEMPORAL_MODEL
        temporal_kw = dict(
            receptive_field=self.receptive_field, input_shape=bev_size,
            start_out_channels=tm.START_OUT_CHANNELS,
            extra_in_channels=tm.EXTRA_IN_CHANNELS,
            inbetween_layers=tm.INBETWEEN_LAYERS,
            use_pyramid_pooling=tm.PYRAMID_POOLING)

        if self.use_camera:
            enc = cfg.MODEL.ENCODER
            self.encoder = Encoder(
                enc.OUT_CHANNELS, self.depth_channels, enc.NAME,
                enc.DOWNSAMPLE, enc.USE_DEPTH_DISTRIBUTION)
            cam_in = enc.OUT_CHANNELS + (6 if tm.INPUT_EGOPOSE else 0)
            if tm.NAME == 'identity':
                self.temporal_model = TemporalModelIdentity()
            else:
                self.temporal_model = TemporalModel(cam_in, **temporal_kw)

        if self.use_lidar:
            se = cfg.MODEL.SPARSE_ENCODER
            # any backbone but pillar8x is the sparse encoder, as in the
            # JAX package
            if cfg.MODEL.LIDAR.BACKBONE == 'pillar8x':
                self.lidar_encoder = PillarBEVEncoder(
                    se, tile_sorted=cfg.MODEL.LIDAR.TILE_SORTED_POINTS)
            else:
                self.lidar_encoder = LidarBEVEncoder(se)
            lidar_in = self.lidar_encoder.out_channels
            self.lidar_pre_reduce = cfg.MODEL.LIDAR.PRE_REDUCE_TEMPORAL
            if self.lidar_pre_reduce:
                self.lidar_reduce = conv2d(lidar_in, tm.START_OUT_CHANNELS, 1)
                lidar_in = tm.START_OUT_CHANNELS
            self.temporal_model_lidar = TemporalModel(lidar_in, **temporal_kw)

        fp = cfg.MODEL.FUTURE_PRED
        if self.n_future > 0:
            self.future_prediction = FuturePredictionODE(
                in_channels=tm.START_OUT_CHANNELS,
                latent_dim=cfg.MODEL.DISTRIBUTION.LATENT_DIM,
                delta_t=fp.DELTA_T, n_gru_blocks=fp.N_GRU_BLOCKS,
                n_res_layers=fp.N_RES_LAYERS, solver=cfg.MODEL.SOLVER,
                impute=cfg.MODEL.IMPUTE, variable_step=fp.USE_VARIABLE_ODE_STEP,
                srvp_filter_size=cfg.MODEL.SMALL_ENCODER.FILTER_SIZE,
                skipco=cfg.MODEL.SMALL_ENCODER.SKIPCO,
                max_gap_seconds=fp.MAX_GAP_SECONDS,
                stochastic=cfg.PROBABILISTIC.ENABLED)

        if cfg.PLANNING.ENABLED:
            # the planner: the forward does not call it; the train module
            # runs it on the forward's outputs (training/trainer.py), as
            # evaluate does on the forecast
            self.planning = Planning(
                cfg, feature_channel=cfg.MODEL.ENCODER.OUT_CHANNELS,
                gru_state_size=cfg.PLANNING.GRU_STATE_SIZE)

        self.latent_dim = cfg.MODEL.DISTRIBUTION.LATENT_DIM
        if cfg.PROBABILISTIC.ENABLED:
            # the latent head: the forward never calls it (nor does the
            # reference's), so it is the distribution_forward method, and a
            # JAX tree made by init has no leaves for it (convert.py)
            self.present_distribution = DistributionModule(
                tm.START_OUT_CHANNELS, self.latent_dim,
                cfg.PROBABILISTIC.METHOD)

        self.decoder = Decoder(
            tm.START_OUT_CHANNELS,
            n_classes=len(cfg.SEMANTIC_SEG.VEHICLE.WEIGHTS),
            n_present=self.receptive_field,
            n_hdmap=len(cfg.SEMANTIC_SEG.HDMAP.ELEMENTS),
            predict_pedestrian=cfg.SEMANTIC_SEG.PEDESTRIAN.ENABLED,
            perceive_hdmap=cfg.SEMANTIC_SEG.HDMAP.ENABLED,
            predict_instance=cfg.INSTANCE_SEG.ENABLED,
            predict_future_flow=cfg.INSTANCE_FLOW.ENABLED,
            planning=cfg.PLANNING.ENABLED)

    def _remat_on(self) -> bool:
        """MODEL.REMAT is set and a backward pass will follow."""
        return (self.cfg.MODEL.REMAT and self.training
                and torch.is_grad_enabled())

    def _run(self, module, *args):
        """``module(*args)``, rematerialised under MODEL.REMAT (a module
        without parameters, the identity temporal model, runs as it is)."""
        if self._remat_on() and next(module.parameters(), None) is not None:
            return remat(module, module, self._generator, *args)
        return module(*args)

    def diagnostics(self) -> Dict[str, torch.Tensor]:
        """The last forward's sown diagnostics (the JAX package's
        'diagnostics' collection): the spconv8x encoder's capacity counters,
        int32 device scalars; empty on the other backbones."""
        return dict(getattr(getattr(self, 'lidar_encoder', None),
                            'last_diagnostics', {}))

    def distribution_forward(self, present_features,
                             min_log_sigma: float = -5.0,
                             max_log_sigma: float = 5.0,
                             generator: Optional[torch.Generator] = None
                             ) -> torch.Tensor:
        """A latent sampled from the present state (B, 1, H, W, C),
        broadcast over space: (B, 1, H, W, latent).  Noise only in train
        mode, from ``generator`` (the forward's, when None); in eval mode
        the mean."""
        params = self.present_distribution(present_features)
        gen = None
        if self.training:
            gen = generator if generator is not None else self._generator
            if gen is None:
                raise ValueError('a train-mode distribution_forward draws '
                                 'noise: give it a generator')
        return distribution_forward(
            params, self.latent_dim, self.cfg.PROBABILISTIC.METHOD,
            tuple(present_features.shape[2:4]), gen,
            min_log_sigma=min_log_sigma, max_log_sigma=max_log_sigma)

    # ---------------------------------------------------------------- camera
    def calculate_birds_eye_view_features(self, image, intrinsics,
                                          extrinsics, future_egomotion):
        """image (B, S, N, H, W, 3) -> (BEV (B, S, X, Y, C), depth logits
        (B, S, N, fH, fW, D), present front-camera feature (B, fH, fW, C))."""
        b, s, n = image.shape[:3]
        frustum = torch.as_tensor(self.frustum, device=intrinsics.device)
        geometry = G.get_geometry(frustum, intrinsics.reshape(b * s, n, 3, 3),
                                  extrinsics.reshape(b * s, n, 4, 4))
        geometry = geometry.reshape(b, s, *geometry.shape[1:])

        flat = image.reshape(b * s * n, *image.shape[3:]).permute(0, 3, 1, 2)
        feature, depth = self._run(self.encoder, flat)  # NCHW
        fh, fw = feature.shape[2:]
        names = list(self.cfg.IMAGE.NAMES)
        front = (names.index('CAM_FRONT') if 'CAM_FRONT' in names
                 else min(1, n - 1))
        cam_front = feature.reshape(b, s, n, -1, fh, fw)[:, -1, front]
        cam_front = cam_front.permute(0, 2, 3, 1)

        if depth is not None:
            depth_prob = torch.softmax(depth, dim=1)
            # depth x feature outer product, laid out (b, s, n, D, fh, fw, C)
            x = depth_prob[:, :, None] * feature[:, None]  # (bsn, D, C, h, w)
            x = x.permute(0, 1, 3, 4, 2).contiguous()
            depth_out = depth.permute(0, 2, 3, 1).reshape(
                b, s, n, fh, fw, self.depth_channels)
        else:
            x = feature.permute(0, 2, 3, 1)[:, None].expand(
                -1, self.depth_channels, -1, -1, -1).contiguous()
            depth_out = None
        x = x.reshape(b, s, n, self.depth_channels, fh, fw, x.shape[-1])

        ego_mat = G.pose_vec2mat(future_egomotion)
        bev = projection_to_birds_eye_view(
            x, geometry, ego_mat, self.bev_start_position,
            self.bev_resolution, self.bev_dimension,
            discount=self.cfg.LIFT.DISCOUNT,
            backend=self.cfg.MODEL.BEV_POOL_BACKEND)
        return bev, depth_out, cam_front

    # ------------------------------------------------------------------ main
    def forward(self, image=None, intrinsics=None, extrinsics=None,
                future_egomotion=None, camera_timestamp=None, points=None,
                lidar_timestamp=None, target_timestamp=None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Optional[torch.Tensor]]:
        """Channels-last inputs (as streamingflow_tpu's StreamingFlow) ->
        dict of channels-last outputs.  ``generator`` drives the GRU-ODE's
        latent sampling when PROBABILISTIC.ENABLED and, in train mode, the
        dropout and drop-connect masks."""
        cfg = self.cfg
        self._generator = generator
        if self.training:
            set_generator(self, generator)
        rf = self.receptive_field
        output: Dict[str, Optional[torch.Tensor]] = {}
        camera_states = lidar_states = states = None
        future_egomotion = future_egomotion[:, :rf]

        if self.use_lidar:
            enc = self.lidar_encoder
            if self._remat_on() and isinstance(enc, PillarBEVEncoder):
                # the bin-sums take no gradient: they run once, outside the
                # rematerialised ladder
                feat = remat(enc.ladder, enc, self._generator,
                             enc.pillar_features(points))
            elif self._remat_on() and not enc.remat_ladder:
                # spconv8x: the geometry (voxelize, maps, taps, occupancy)
                # takes no gradient and runs once, outside; under
                # REMAT_LADDER the encoder checkpoints each block itself
                geo = enc.geometry(points)
                feat = remat(enc.ladder, enc, self._generator, geo.feats, geo)
            else:
                feat = enc(points)                       # (B, T, C, X, Y)
            # SPARSE_ENCODER.COMPUTE_DTYPE may leave the branch narrower
            # than the weights it meets (bf16 features, fp32 parameters in
            # training): widen, as flax promotes; the rounding stays
            feat = feat.to(torch.promote_types(
                feat.dtype, self.decoder.first_conv.weight.dtype))
            if self.lidar_pre_reduce:
                b, t = feat.shape[:2]
                feat = self.lidar_reduce(feat.flatten(0, 1))
                feat = feat.reshape(b, t, *feat.shape[1:])
            lidar_states = self._run(self.temporal_model_lidar, feat)
            states = lidar_states

        if self.use_camera:
            x, depth, cam_front = self.calculate_birds_eye_view_features(
                image[:, :rf], intrinsics[:, :rf], extrinsics[:, :rf],
                future_egomotion)
            output['depth_prediction'] = depth
            output['cam_front'] = cam_front
            if cfg.MODEL.TEMPORAL_MODEL.INPUT_EGOPOSE:
                b, s, h, w = x.shape[:4]
                ego = future_egomotion[:, :, None, None, :].expand(
                    b, s, h, w, 6)
                # zero egomotion at t = 0
                ego = torch.cat([torch.zeros_like(ego[:, :1]),
                                 ego[:, :rf - 1]], dim=1)
                x = torch.cat([x, ego.to(x.dtype)], dim=-1)
            camera_states = self._run(self.temporal_model,
                                      x.permute(0, 1, 4, 2, 3))
            states = camera_states

        if self.n_future > 0:
            states = self._run(
                self.future_prediction, states[:, -1:], camera_states,
                camera_timestamp, lidar_states, lidar_timestamp,
                target_timestamp, generator)

        for k, v in self._run(self.decoder, states).items():
            if v is not None and k != 'costvolume':
                # (.., K, H, W) -> (.., H, W, K)
                v = v.movedim(-3, -1)
            output[k] = v
        return output


def build_model(cfg: Config, device=None, dtype: torch.dtype = torch.float32,
                seed: Optional[int] = None) -> StreamingFlow:
    """The eval-mode model on ``device`` ('cuda' unless asked for 'cpu';
    raises when CUDA is absent and no device was given).  ``seed`` makes the
    random initial weights reproducible; ``dtype`` casts parameters and
    BN statistics (bf16 for the mixed-precision forward)."""
    dev = resolve_device(device)
    if seed is not None:
        torch.manual_seed(seed)
    return StreamingFlow(cfg).to(device=dev, dtype=dtype).eval()
