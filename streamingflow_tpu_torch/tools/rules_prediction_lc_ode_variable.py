"""Rule table of a reference checkpoint of `Prediction_LC_ODE_Variable`:
the reference module tree (streamingflow/models/streamingflow.py:24-207,
encoder.py:10, temporal_model.py:8, future_prediction_ode.py:9,
temporal_ode_bayes.py:355, decoder.py:8, mmdet3d sparse_encoder.py:11-133,
trainer.py:46-101 task weights) onto the flax variable paths that the
port's modules carry as names.

The port's own copy of the JAX package's table of the same name; read by
streamingflow_tpu_torch/tools/convert_checkpoint.py (its default
``--rules``) through utils/torch_convert.py.  Each rule is
``(flax_path_regex, torch_key_template, kind)``; rules are tried in order.

Reference keys not mapped (IGNORED_TORCH):
  * bev_resolution / bev_start_position / bev_dimension / frustum -
    geometry buffers recomputed from the config (streamingflow.py:30-41)
  * *.num_batches_tracked - torch BN step counters, unused functionally
Port leaves not mapped (IGNORED_FLAX):
  * present_distribution/* - the reference never constructs its
    `present_distribution` (distribution_forward is dead code there), so a
    real checkpoint carries no such weights; they keep their own
    initialisation.
"""

RULES = []

P = 'params/model/'
PB = r'(?:params|batch_stats)/model/'


def raw(f, t):
    RULES.append((f, t, 'raw'))


def conv(f, t):
    RULES.append((f, t, 'conv'))


def convT(f, t):
    RULES.append((f, t, 'conv_transpose'))


def linear(f, t):
    RULES.append((f, t, 'linear'))


def spconv(f, t):
    RULES.append((f, t, 'spconv'))


def bn(f, t):
    """f is the flax BN scope (no leaf); covers scale/bias/mean/var."""
    RULES.append((f + r'/(?:scale|bias|mean|var)', t, 'bn'))


def ln(f, t):
    RULES.append((f + '/scale', t + '.weight', 'raw'))
    RULES.append((f + '/bias', t + '.bias', 'raw'))


def convblock(f, t, bias=False, transpose=False, norm=True):
    """flax ConvBlock scope -> torch ConvBlock (conv + optional norm)."""
    if transpose:
        convT(f + '/ConvTranspose_0/kernel', t + '.conv.weight')
        if bias:
            raw(f + '/ConvTranspose_0/bias', t + '.conv.bias')
    else:
        conv(f + '/Conv_0/kernel', t + '.conv.weight')
        if bias:
            raw(f + '/Conv_0/bias', t + '.conv.bias')
    if norm:
        bn(f.replace(P, PB, 1) + '/BatchNorm_0', t + '.norm')


def resblock(f, t):
    """flax srvp.ResBlock -> torch res_models.ResBlock."""
    convblock(f + '/ConvBlock_0', t + '.layers.conv_1')
    convblock(f + '/ConvBlock_1', t + '.layers.conv_2')
    conv(f + '/Conv_0/kernel', t + '.projection.weight')
    raw(f + '/Conv_0/bias', t + '.projection.bias')


def selayer(f, t):
    linear(f + '/Dense_0/kernel', t + '.fc.0.weight')
    linear(f + '/Dense_1/kernel', t + '.fc.2.weight')


def aspp(f, t):
    """flax ASPP scope -> torch torchvision-style ASPP module prefix."""
    fb = f.replace(P, PB, 1)
    for i in range(4):                       # 1x1 + three atrous branches
        conv(f + f'/Conv_{i}/kernel', t + f'.convs.{i}.0.weight')
        bn(fb + f'/BatchNorm_{i}', t + f'.convs.{i}.1')
    conv(f + '/Conv_4/kernel', t + '.convs.4.1.weight')   # image pooling
    bn(fb + '/BatchNorm_4', t + '.convs.4.2')
    conv(f + '/Conv_5/kernel', t + '.project.0.weight')
    bn(fb + '/BatchNorm_5', t + '.project.1')


def deeplab(f, t):
    """flax DeepLabHead scope -> torch Sequential(ASPP, conv, bn, relu, 1x1).
    """
    aspp(f + '/ASPP_0', t + '.0')
    conv(f + '/Conv_0/kernel', t + '.1.weight')
    bn(f.replace(P, PB, 1) + '/BatchNorm_0', t + '.2')
    conv(f + '/Conv_1/kernel', t + '.4.weight')
    raw(f + '/Conv_1/bias', t + '.4.bias')


def upsampling_concat(f, t):
    """flax UpsamplingConcat -> torch .conv Sequential(conv,bn,relu,conv,bn,
    relu)."""
    fb = f.replace(P, PB, 1)
    conv(f + '/Conv_0/kernel', t + '.conv.0.weight')
    bn(fb + '/BatchNorm_0', t + '.conv.1')
    conv(f + '/Conv_1/kernel', t + '.conv.3.weight')
    bn(fb + '/BatchNorm_1', t + '.conv.4')


def bottleblock(f, t):
    """flax Bottleblock -> torch Bottleblock (layers.{0,1,3,4,6,7} +
    projection.0)."""
    conv(f + '/Conv_0/kernel', t + '.layers.0.weight')
    ln(f + '/LayerNorm_0', t + '.layers.1')
    conv(f + '/Conv_1/kernel', t + '.layers.3.weight')
    ln(f + '/LayerNorm_1', t + '.layers.4')
    conv(f + '/Conv_2/kernel', t + '.layers.6.weight')
    ln(f + '/LayerNorm_2', t + '.layers.7')
    conv(f + '/Conv_3/kernel', t + '.projection.0.weight')


def gru_gates(f, t, suffix=''):
    """flax GRUGates (fused gates_kernel = update‖reset on the output-channel
    axis + proposal_kernel) -> torch conv_update{suffix}/conv_reset{suffix}/
    conv_state_tilde{suffix} ('|'-joined templates concatenate)."""
    RULES.append((f + '/gates_kernel',
                  t + f'.conv_update{suffix}.weight|'
                  + t + f'.conv_reset{suffix}.weight', 'conv_cat'))
    RULES.append((f + '/gates_bias',
                  t + f'.conv_update{suffix}.bias|'
                  + t + f'.conv_reset{suffix}.bias', 'raw_cat'))
    conv(f + '/proposal_kernel', t + f'.conv_state_tilde{suffix}.weight')
    raw(f + '/proposal_bias', t + f'.conv_state_tilde{suffix}.bias')


def dual_gru_cell(f, t):
    """flax DualGRUCell -> torch DualGRUODECell / DualGRUCell."""
    gru_gates(f + '/gru_cell_1', t, '_1')
    gru_gates(f + '/gru_cell_2', t, '_2')
    conv(f + '/Conv_0/kernel', t + '.conv_decoder_2.weight')
    raw(f + '/Conv_0/bias', t + '.conv_decoder_2.bias')
    bottleblock(f + '/trusting_gate_block', t + '.trusting_gate.0')
    conv(f + '/trusting_gate_conv/kernel', t + '.trusting_gate.1.weight')


def convnext(f, t):
    conv(f + '/Conv_0/kernel', t + '.dwconv.weight')
    raw(f + '/Conv_0/bias', t + '.dwconv.bias')
    ln(f + '/LayerNorm_0', t + '.norm')
    linear(f + '/Dense_0/kernel', t + '.pwconv1.weight')
    raw(f + '/Dense_0/bias', t + '.pwconv1.bias')
    linear(f + '/Dense_1/kernel', t + '.pwconv2.weight')
    raw(f + '/Dense_1/bias', t + '.pwconv2.bias')
    raw(f + '/gamma', t + '.gamma')


def temporal_block(f, t):
    """flax TemporalBlock -> torch layers/temporal.py TemporalBlock."""
    fb = f.replace(P, PB, 1)
    for i in range(2):   # compression+causal conv paths ((2,3,3), (1,3,3))
        conv(f + f'/Conv1x1x1NormActivated_{i}/Conv_0/kernel',
             t + f'.convolution_paths.{i}.0.conv.weight')
        bn(fb + f'/Conv1x1x1NormActivated_{i}/BatchNorm_0',
           t + f'.convolution_paths.{i}.0.norm')
        conv(f + f'/CausalConv3d_{i}/Conv_0/kernel',
             t + f'.convolution_paths.{i}.1.conv.weight')
        bn(fb + f'/CausalConv3d_{i}/BatchNorm_0',
           t + f'.convolution_paths.{i}.1.norm')
    conv(f + '/Conv1x1x1NormActivated_2/Conv_0/kernel',
         t + '.convolution_paths.2.conv.weight')
    bn(fb + '/Conv1x1x1NormActivated_2/BatchNorm_0',
       t + '.convolution_paths.2.norm')
    # NB: f/t already carry group \1 (the block index), so the pyramid
    # feature index is backreference \2
    conv(f + r'/PyramidSpatioTemporalPooling_0/Conv1x1x1NormActivated_(\d+)'
           r'/Conv_0/kernel',
         t + r'.pyramid_pooling.features.\2.conv_bn_relu.conv.weight')
    bn(fb + r'/PyramidSpatioTemporalPooling_0/Conv1x1x1NormActivated_(\d+)'
            r'/BatchNorm_0',
       t + r'.pyramid_pooling.features.\2.conv_bn_relu.norm')
    conv(f + '/Conv1x1x1NormActivated_3/Conv_0/kernel',
         t + '.aggregation.0.conv.weight')
    bn(fb + '/Conv1x1x1NormActivated_3/BatchNorm_0', t + '.aggregation.0.norm')
    conv(f + '/Conv_0/kernel', t + '.projection.0.weight')
    bn(fb + '/BatchNorm_0', t + '.projection.1')


# ======================================================= task uncertainties
raw(r'params/task_weights/(\w+_weight)', r'\1')

# ===================================================== camera EfficientNet
E = P + 'encoder/backbone'
EB = PB + 'encoder/backbone'
TB = 'encoder.backbone'
conv(E + '/conv_stem/kernel', TB + '._conv_stem.weight')
bn(EB + '/BatchNorm_0', TB + '._bn0')
conv(E + r'/block_(\d+)/expand_conv/kernel', TB + r'._blocks.\1._expand_conv.weight')
conv(E + r'/block_(\d+)/depthwise_conv/kernel',
     TB + r'._blocks.\1._depthwise_conv.weight')
conv(E + r'/block_(\d+)/se_reduce/kernel', TB + r'._blocks.\1._se_reduce.weight')
raw(E + r'/block_(\d+)/se_reduce/bias', TB + r'._blocks.\1._se_reduce.bias')
conv(E + r'/block_(\d+)/se_expand/kernel', TB + r'._blocks.\1._se_expand.weight')
raw(E + r'/block_(\d+)/se_expand/bias', TB + r'._blocks.\1._se_expand.bias')
conv(E + r'/block_(\d+)/project_conv/kernel',
     TB + r'._blocks.\1._project_conv.weight')
# BN numbering: blocks without an expand conv shift every index down one;
# the engine falls through on missing keys / shape mismatches / reuse
bn(EB + r'/block_(\d+)/BatchNorm_0', TB + r'._blocks.\1._bn0')
bn(EB + r'/block_(\d+)/BatchNorm_0', TB + r'._blocks.\1._bn1')
bn(EB + r'/block_(\d+)/BatchNorm_1', TB + r'._blocks.\1._bn1')
bn(EB + r'/block_(\d+)/BatchNorm_1', TB + r'._blocks.\1._bn2')
bn(EB + r'/block_(\d+)/BatchNorm_2', TB + r'._blocks.\1._bn2')

# ----------------------------------------------------------- encoder necks
for neck in ('feature', 'depth'):
    deeplab(P + f'encoder/{neck}_layer_1', f'encoder.{neck}_layer_1')
    upsampling_concat(P + f'encoder/{neck}_layer_2', f'encoder.{neck}_layer_2')

# ====================================================== temporal models x2
for name in ('temporal_model', 'temporal_model_lidar'):
    temporal_block(P + name + r'/TemporalBlock_(\d+)', name + r'.model.\1')
    deeplab(P + name + '/final_conv', name + '.final_conv')

# ================================================== GRU-ODE future predictor
F = P + 'future_prediction'
TF = 'future_prediction_ode'
G = F + '/gru_ode'
TG = TF + '.gru_ode'
dual_gru_cell(G + '/gru_c', TG + '.gru_c')
dual_gru_cell(G + '/gru_obs', TG + '.gru_obs.gru_d')

# p_model (ConvNet): ResBlock/SE/ResBlock/SE/ConvBlock
resblock(G + '/p_model/ResBlock_0', TG + '.p_model.model.0')
selayer(G + '/p_model/SELayer_0', TG + '.p_model.model.1')
resblock(G + '/p_model/ResBlock_1', TG + '.p_model.model.2')
selayer(G + '/p_model/SELayer_1', TG + '.p_model.model.3')
conv(G + '/p_model/ConvBlock_0/Conv_0/kernel', TG + '.p_model.model.4.conv.weight')
raw(G + '/p_model/ConvBlock_0/Conv_0/bias', TG + '.p_model.model.4.conv.bias')

# SRVP encoder: 5 ResBlocks + tanh ConvBlock
RULES.append((G + r'/srvp_encoder/ResBlock_(\d+)/ConvBlock_0/Conv_0/kernel',
              TG + r'.srvp_encoder.blocks.\1.layers.conv_1.conv.weight',
              'conv'))
bn(PB + r'future_prediction/gru_ode/srvp_encoder/ResBlock_(\d+)/ConvBlock_0'
        r'/BatchNorm_0',
   TG + r'.srvp_encoder.blocks.\1.layers.conv_1.norm')
RULES.append((G + r'/srvp_encoder/ResBlock_(\d+)/ConvBlock_1/Conv_0/kernel',
              TG + r'.srvp_encoder.blocks.\1.layers.conv_2.conv.weight',
              'conv'))
bn(PB + r'future_prediction/gru_ode/srvp_encoder/ResBlock_(\d+)/ConvBlock_1'
        r'/BatchNorm_0',
   TG + r'.srvp_encoder.blocks.\1.layers.conv_2.norm')
conv(G + r'/srvp_encoder/ResBlock_(\d+)/Conv_0/kernel',
     TG + r'.srvp_encoder.blocks.\1.projection.weight')
raw(G + r'/srvp_encoder/ResBlock_(\d+)/Conv_0/bias',
    TG + r'.srvp_encoder.blocks.\1.projection.bias')
convblock(G + '/srvp_encoder/ConvBlock_0', TG + '.srvp_encoder.last_conv.0')

# SRVP decoder: transpose first conv, 5 ResBlocks, two last convs
convblock(G + '/srvp_decoder/ConvBlock_0', TG + '.srvp_decoder.first_upconv',
          transpose=True)
RULES.append((G + r'/srvp_decoder/ResBlock_(\d+)/ConvBlock_0/Conv_0/kernel',
              TG + r'.srvp_decoder.blocks.\1.layers.conv_1.conv.weight',
              'conv'))
bn(PB + r'future_prediction/gru_ode/srvp_decoder/ResBlock_(\d+)/ConvBlock_0'
        r'/BatchNorm_0',
   TG + r'.srvp_decoder.blocks.\1.layers.conv_1.norm')
RULES.append((G + r'/srvp_decoder/ResBlock_(\d+)/ConvBlock_1/Conv_0/kernel',
              TG + r'.srvp_decoder.blocks.\1.layers.conv_2.conv.weight',
              'conv'))
bn(PB + r'future_prediction/gru_ode/srvp_decoder/ResBlock_(\d+)/ConvBlock_1'
        r'/BatchNorm_0',
   TG + r'.srvp_decoder.blocks.\1.layers.conv_2.norm')
conv(G + r'/srvp_decoder/ResBlock_(\d+)/Conv_0/kernel',
     TG + r'.srvp_decoder.blocks.\1.projection.weight')
raw(G + r'/srvp_decoder/ResBlock_(\d+)/Conv_0/bias',
    TG + r'.srvp_decoder.blocks.\1.projection.bias')
convblock(G + '/srvp_decoder/ConvBlock_1', TG + '.srvp_decoder.last_conv.0')
convblock(G + '/srvp_decoder/ConvBlock_2', TG + '.srvp_decoder.last_conv.1',
          transpose=True, bias=True, norm=False)

# refinement: SpatialGRU + [ConvNeXt block | DeepLabHead]
for i in range(2):
    gru_gates(F + f'/spatial_gru_{i}/GRUGates_0', f'{TF}.spatial_grus.{i}')
    conv(F + f'/spatial_gru_{i}/Conv_0/kernel',
         f'{TF}.spatial_grus.{i}.conv_decoder.weight')
convnext(F + '/res_block_0_0', TF + '.res_blocks.0.0')
deeplab(F + '/res_block_1', TF + '.res_blocks.1')

# ===================================================== LiDAR sparse encoder
L = P + 'lidar_encoder'
LB = PB + 'lidar_encoder'
TL = 'encoders.lidar.backbone'
spconv(L + '/conv_input/kernel', TL + '.conv_input.0.weight')
bn(LB + '/conv_input/MaskedBatchNorm_0', TL + '.conv_input.1')
spconv(L + r'/stage(\d)_block(\d)/kernel1',
       TL + r'.encoder_layers.encoder_layer\1.\2.conv1.weight')
spconv(L + r'/stage(\d)_block(\d)/kernel2',
       TL + r'.encoder_layers.encoder_layer\1.\2.conv2.weight')
bn(LB + r'/stage(\d)_block(\d)/bn1',
   TL + r'.encoder_layers.encoder_layer\1.\2.bn1')
bn(LB + r'/stage(\d)_block(\d)/bn2',
   TL + r'.encoder_layers.encoder_layer\1.\2.bn2')
spconv(L + r'/down(\d)/kernel', TL + r'.encoder_layers.encoder_layer\1.2.0.weight')
bn(LB + r'/down(\d)/MaskedBatchNorm_0',
   TL + r'.encoder_layers.encoder_layer\1.2.1')
spconv(L + '/conv_out/kernel', TL + '.conv_out.0.weight')
bn(LB + '/conv_out/MaskedBatchNorm_0', TL + '.conv_out.1')

# =============================================================== decoder
D = P + 'decoder'
DB = PB + 'decoder'
conv(D + '/first_conv/kernel', 'decoder.first_conv.weight')
bn(DB + '/BatchNorm_0', 'decoder.bn1')
# BasicBlock_{0..5} -> layer{1..3}.{0,1}
for i in range(6):
    layer, blk = i // 2 + 1, i % 2
    tb = f'decoder.layer{layer}.{blk}'
    conv(D + f'/BasicBlock_{i}/Conv_0/kernel', tb + '.conv1.weight')
    bn(DB + f'/BasicBlock_{i}/BatchNorm_0', tb + '.bn1')
    conv(D + f'/BasicBlock_{i}/Conv_1/kernel', tb + '.conv2.weight')
    bn(DB + f'/BasicBlock_{i}/BatchNorm_1', tb + '.bn2')
    conv(D + f'/BasicBlock_{i}/Conv_2/kernel', tb + '.downsample.0.weight')
    bn(DB + f'/BasicBlock_{i}/BatchNorm_2', tb + '.downsample.1')
for i in (1, 2, 3):
    conv(D + f'/up{i}_skip/Conv_0/kernel',
         f'decoder.up{i}_skip.upsample_layer.1.weight')
    bn(DB + f'/up{i}_skip/BatchNorm_0',
       f'decoder.up{i}_skip.upsample_layer.2')
for head in ('segmentation_head', 'pedestrian_head', 'hdmap_head',
             'instance_offset_head', 'instance_center_head',
             'instance_future_head', 'costvolume_head'):
    conv(D + f'/{head}_conv1/kernel', f'decoder.{head}.0.weight')
    bn(DB + f'/{head}_bn', f'decoder.{head}.1')
    conv(D + f'/{head}_conv2/kernel', f'decoder.{head}.3.weight')
    raw(D + f'/{head}_conv2/bias', f'decoder.{head}.3.bias')


# --------------------------------------------------------------- whitelists
# torch keys a real checkpoint carries that we deliberately do not load
IGNORED_TORCH = [
    r'.*num_batches_tracked$',
    r'^(bev_resolution|bev_start_position|bev_dimension|frustum)$',
]
# flax leaves that have no reference counterpart
IGNORED_FLAX = [
    r'.*present_distribution.*',
]
