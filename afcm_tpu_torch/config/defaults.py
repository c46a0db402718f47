"""Default configuration tree.

Keys mirror the reference schema 1:1 (reference: configs/defaults.py:3-178)
so the shipped experiment YAMLs translate mechanically, plus the per-model
default subtrees the reference injects through
``modify_commandline_options`` (reference: models/stylegan3_model.py:32-83,
models/comodgan_model.py:34-75, models/pix2pix_model.py:16-65).

The port's own copy of ``afcm_tpu/config/defaults.py`` (host code, numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from .config import CfgNode


def get_default_cfg() -> CfgNode:
    c = CfgNode()
    c.VERSION = 2
    c.name = "cmsr_pix2pix"
    c.direction = "AtoB"
    c.isTrain = True
    c.extra_b = False
    c.checkpoints_dir = "./checkpoints"
    c.continue_train = False
    c.load_iter = 0
    c.epoch = None
    c.verbose = False
    c.manual_seed = None

    c.loaders = CfgNode()
    c.loaders.dataset_mode = "cmsr"
    c.loaders.batch_size = 8
    c.loaders.serial_batches = False
    c.loaders.num_threads = 8
    c.loaders.mirror_padding = [0, 0, 0]
    c.loaders.raw_internal_path_in = ["T2_FLAIR", "T1"]
    c.loaders.raw_internal_path_out = ["T2_FLAIR", "T1"]
    c.loaders.rand_output = False
    c.loaders.cat_inputs = False
    c.loaders.slice_num = 4
    c.loaders.random_modality_in = False
    c.loaders.random_modality_out = False
    c.loaders.preprocess = "none"
    # image-folder dataset keys (aligned/unaligned/single; reference:
    # data/base_dataset.py get_transform + options/base_options defaults)
    c.loaders.dataroot = ""
    c.loaders.load_size = 286
    c.loaders.crop_size = 256
    c.loaders.max_dataset_size = 0       # 0 = unbounded
    c.loaders.thickness = []
    c.loaders.out_thickness = 1.0
    c.loaders.global_normalization = None

    c.loaders.train = CfgNode()
    c.loaders.train.file_paths = ["../cmsr_data/data_h5/train"]
    c.loaders.train.slice_builder = CfgNode()
    c.loaders.train.slice_builder.name = "FilterSliceBuilder"
    c.loaders.train.slice_builder.patch_shape = [1, 128, 128]
    c.loaders.train.slice_builder.stride_shape = [1, 64, 64]
    c.loaders.train.slice_builder.threshold = 0.0
    c.loaders.train.slice_builder.slack_acceptance = 0.01
    c.loaders.train.slice_builder.gray_threshold = 200
    c.loaders.train.slice_builder.gray_percentile = 0.2
    c.loaders.train.transformer = CfgNode()
    c.loaders.train.transformer.raw = _default_transformer(train=True)

    c.loaders.val = CfgNode()
    c.loaders.val.file_paths = []

    c.loaders.test = CfgNode()
    c.loaders.test.ori_file_path = "../../data/cmsr_data/acpc_align_extra_cropped"
    c.loaders.test.file_paths = ["../../data/cmsr_data/acpc_align_extra_cropped_h5/test"]
    c.loaders.test.ref_path = None
    c.loaders.test.prefix = "_predictions0"
    c.loaders.test.slice_builder = CfgNode()
    c.loaders.test.slice_builder.name = "SliceBuilder"
    c.loaders.test.slice_builder.patch_shape = [1, 256, 256]
    c.loaders.test.slice_builder.stride_shape = [1, 16, 16]
    c.loaders.test.slice_builder.threshold = 0.6
    c.loaders.test.slice_builder.slack_acceptance = 0.01
    c.loaders.test.slice_builder.gray_threshold = 100
    c.loaders.test.slice_builder.gray_percentile = 0.2
    c.loaders.test.transformer = CfgNode()
    c.loaders.test.transformer.raw = _default_transformer(train=False)

    c.model = CfgNode()
    c.model.name = "stylegan3"
    c.model.combine_ab = True
    c.model.output_heads = 3
    c.model.G = CfgNode()
    c.model.G.netG = "stylegan3"
    c.model.D = CfgNode()
    c.model.D.netD = "comodgan"

    c.optimizer = CfgNode()
    c.optimizer.lr_G = 0.0002
    c.optimizer.lr_D = 0.0002
    c.optimizer.lr = 0.0025   # legacy single-lr key used by comodgan yml
    c.optimizer.beta1 = 0.5

    c.loss = CfgNode()
    c.loss.gan_mode = "vanilla"
    c.loss.lambda_L1 = 100.0
    c.loss.lambda_r1 = 10.0
    # wgangp gradient penalty weight (pix2pix baseline; 0 = off, matching
    # the reference, whose pix2pix never calls cal_gradient_penalty)
    c.loss.lambda_gp = 0.0
    # Lazy R1 interval (extension; 1 = reference-faithful every-step R1).
    # N > 1 runs the R1 double-grad every Nth step scaled by N — the
    # integrated strength is preserved but the schedule deviates from the
    # reference, so it is opt-in.
    c.loss.r1_interval = 1
    c.loss.blur_init_sigma = 0.0
    c.loss.blur_fade_kimg = 0.0

    c.scheduler = CfgNode()
    c.scheduler.n_epochs = 100
    c.scheduler.epoch_count = 1
    c.scheduler.n_epochs_decay = 100
    c.scheduler.lr_decay_iters = 50
    c.scheduler.lr_policy = "linear"
    c.scheduler.ema = CfgNode()
    c.scheduler.ema.enabled = False
    c.scheduler.ema.ema_kimgs = 10
    c.scheduler.ema.ramp = None

    c.display = CfgNode()
    c.display.display_id = 0
    c.display.use_html = False
    c.display.display_server = "http://localhost"
    c.display.display_port = 8097
    c.display.display_env = "main"
    c.display.display_winsize = 256
    c.display.display_ncols = 4
    c.display.use_wandb = False
    c.display.wandb_project_name = "cmsr"

    c.trainer = CfgNode()
    c.trainer.print_freq = 100
    c.trainer.display_freq = 400
    c.trainer.update_html_freq = 1000
    c.trainer.save_latest_freq = 5000
    c.trainer.save_epoch_freq = 5000
    c.trainer.save_by_iter = False
    c.trainer.max_iters = 0          # 0 = unbounded (epoch-driven)

    c.predictor = CfgNode()
    c.predictor.name = "StandardPredictor"
    c.predictor.patch_halo = [0, 8, 8]

    # Device knobs (no reference equivalent); the section keeps the name the
    # shared YAML files use
    c.tpu = CfgNode()
    c.tpu.mesh_shape = [0, 1]        # [data, model]; 0 = all devices on data
    c.tpu.compute_dtype = "float32"  # float32 | bfloat16
    c.tpu.matmul_precision = "default"  # default | high | highest
    c.tpu.remat = False
    c.tpu.remat_min_size = 0   # remat only layers >= this spatial size
    # Share one G forward between the D and G train phases (compute the fake
    # + its VJP once instead of re-forwarding for the G loss). The
    # reference's pix2pix branch shares its forward exactly this way
    # (pix2pix_model.py:163-174); its comodgan/stylegan3 branches re-forward
    # per phase, which only redraws dropout. The saving is the generator's
    # second forward. Set False for the reference's exact
    # fresh-dropout-per-phase semantics.
    c.tpu.shared_g_fwd = True
    # xla | auto | pallas: the JAX package's choice between its plain
    # composition and its Pallas kernel. The port only checks it
    # (evaluate.check_device_knobs): a CUDA tensor always takes the CUDA
    # kernel (ops/cuda/filtered_lrelu.py).
    c.tpu.filtered_lrelu_impl = "xla"
    # Serving input transfer: "uint8" ships test patches host->device in the
    # volume's stored byte dtype and moves the Normalize->[-1,1] chain into
    # the device forward (a quarter of the host->device bytes; matches the
    # float path within 1 ULP).
    # Falls back to float32 when the transform chain isn't Normalize->ToTensor
    # or the volume isn't uint8.
    c.tpu.transfer_dtype = "float32"    # float32 | uint8
    # Serving output fetch: "bfloat16" halves device->host traffic for the
    # predictor's prediction batches. With compute_dtype bfloat16 the values
    # were computed in bf16 anyway, so the extra rounding is ~1 ULP of the
    # existing drift; stitching still accumulates float32 on host.
    c.tpu.fetch_dtype = "float32"       # float32 | bfloat16
    # Quantized inference: route eligible 3x3 convs to the int8 conv kernel
    # (ops/cuda/conv_int8.py). Applied by evaluate.py; per-layer fidelity
    # above 50 dB, guarded end-to-end by tests/test_torch_int8.py. The port
    # has one kernel and takes either conv_int8_variant.
    c.tpu.conv_int8 = False
    c.tpu.conv_int8_variant = "dots"    # dots | im2col
    c.tpu.conv_int8_min_ch = 64         # channel floor for routing
    # Serving pipeline depth: batches kept in flight across subject
    # boundaries by StandardPredictor.run_pipelined — covers the host-side
    # finalize/metrics/next-subject-load gap. Peak device footprint is
    # depth+1 slots (one extra between a dispatch and its paired fetch);
    # each slot holds one input+output batch (~8 MB at batch 16, 256^2).
    # 0 disables pipelining (strictly serial batches).
    c.tpu.pipeline_depth = 4
    # Test-time z protocol: "per-batch" matches the reference (a fresh
    # gen_z for every test batch, comodgan_model.py:101-108); "fixed"
    # holds ONE z for the whole evaluation run, so a stitched volume's
    # slices share a style — slice-consistent serving output. Matters
    # most for the CoModGAN family, where the global co-modulation makes
    # z dominate early in training (docs/experiments.md round 5).
    c.tpu.eval_z = "per-batch"          # per-batch | fixed
    return c


def _default_transformer(train: bool) -> CfgNode:
    t = CfgNode()
    for name, enabled in [
            ("PercentileNormalizer", False), ("Standardize", False),
            ("Normalize", train is not None and not train),
            ("RandomFlip", False), ("ResizeCrop", False),
            ("RandomRotate90", False), ("RandomRotate", False),
            ("RandomContrast", False), ("ElasticDeformation", False),
            ("GaussianBlur3D", False), ("AdditiveGaussianNoise", False),
            ("AdditivePoissonNoise", False), ("ToTensor", True)]:
        t[name] = CfgNode()
        t[name].enabled = enabled
    t.PercentileNormalizer.pmin = 1.0
    t.PercentileNormalizer.pmax = 99.6
    t.Normalize.min_value = 0.0
    t.Normalize.max_value = 1.0 if train else 255.0
    t.RandomFlip.axes = [0]
    t.ResizeCrop.inter_size = [286, 286]
    t.ResizeCrop.target_size = [256, 256]
    t.ResizeCrop.is_label = False
    t.RandomRotate.axes = [[2, 1]]
    t.RandomRotate.angle_spectrum = 45
    t.RandomRotate.mode = "reflect"
    t.RandomContrast.execution_probability = 0.1
    t.ElasticDeformation.spline_order = 3
    t.GaussianBlur3D.execution_probability = 0.5
    t.AdditiveGaussianNoise.execution_probability = 0.2
    t.AdditivePoissonNoise.execution_probability = 0.2
    t.ToTensor.expand_dims = False
    return t


# -- per-model defaults ------------------------------------------------------


def apply_model_defaults(cfg: CfgNode, model_name: str):
    if model_name == "stylegan3":
        _stylegan3_defaults(cfg)
    elif model_name == "comodgan":
        _comodgan_defaults(cfg)
    elif model_name == "pix2pix":
        _pix2pix_defaults(cfg)
    else:
        raise NotImplementedError(f"unknown model {model_name}")
    return cfg


def _stylegan3_defaults(c: CfgNode):
    """reference: models/stylegan3_model.py:32-83"""
    c.loaders.slice_num = 3
    g = c.model.G
    g.z_dim = 512
    g.w_dim = 512
    g.c_dim = 1
    g.img_resolution = 256
    g.img_channels_in = 4
    g.img_channels_out = 1
    g.netG = "stylegan3"
    g.synthesis_kwargs = CfgNode()
    sk = g.synthesis_kwargs
    sk.channel_base = int(0.5 * 32768)
    sk.channel_max = 512
    sk.num_layers = 14
    sk.num_critical = 2
    sk.first_cutoff = 2.0
    sk.first_stopband = 2 ** 2.1
    sk.last_stopband_rel = 2 ** 0.3
    sk.margin_size = 10
    sk.output_scale = 0.25
    sk.skip_resolution = 128
    sk.conv_kernel = 3
    sk.filter_size = 6
    sk.lrelu_upsampling = 2
    sk.use_radial_filters = False
    sk.conv_clamp = 256
    sk.magnitude_ema_beta = 0.5 ** (16 / (20 * 1e3))
    sk.cond_mod = True
    g.mapping_kwargs = CfgNode()
    g.mapping_kwargs.num_layers = 8

    d = c.model.D
    d.netD = "comodgan"
    d.channel_base = int(0.5 * 32768)
    d.num_fp16_res = 0
    d.conv_clamp = None
    d.channel_max = 512
    d.c_dim = 0
    d.img_resolution = 256
    d.img_channels = 5
    d.mapping_kwargs = CfgNode()
    d.mapping_kwargs.num_layers = 8
    d.epilogue_kwargs = CfgNode()
    d.epilogue_kwargs.mbstd_group_size = 16

    c.loss.blur_init_sigma = 0.0
    c.loss.blur_fade_kimg = 0.0


def _comodgan_defaults(c: CfgNode):
    """reference: models/comodgan_model.py:34-75"""
    c.loaders.slice_num = 3
    g = c.model.G
    g.netG = "comodgan"
    g.z_dim = 512
    g.w_dim = 512
    g.c_dim = 0
    g.img_resolution = 256
    g.img_channels_in = 1
    g.img_channels_out = 1
    g.synthesis_kwargs = CfgNode()
    sk = g.synthesis_kwargs
    sk.name = "SynthesisNetwork"
    sk.channel_base = int(0.5 * 32768)
    sk.channel_max = 512
    sk.skip_resolution = 256
    sk.cond_mod = True
    sk.num_fp16_res = 0
    sk.conv_clamp = None
    sk.channel_attention = False
    g.mapping_kwargs = CfgNode()
    g.mapping_kwargs.name = "MappingNetwork"
    g.mapping_kwargs.num_layers = 8
    g.mapping_kwargs.img_resolution = 256
    g.mapping_kwargs.img_channels = 1
    g.mapping_kwargs.channel_base = int(0.5 * 32768)
    g.mapping_kwargs.channel_max = 512

    d = c.model.D
    d.netD = "comodgan"
    d.channel_base = int(0.5 * 32768)
    d.num_fp16_res = 0
    d.conv_clamp = None
    d.channel_max = 512
    d.c_dim = 0
    d.img_resolution = 256
    d.img_channels = 2
    d.mapping_kwargs = CfgNode()
    d.epilogue_kwargs = CfgNode()
    d.epilogue_kwargs.mbstd_group_size = 16


def _pix2pix_defaults(c: CfgNode):
    """reference: models/pix2pix_model.py:16-65 (the dataset_mode/preprocess
    defaults come from the upstream pix2pix base options: aligned A|B pairs
    with resize-and-crop, reference: data/aligned_dataset.py)"""
    c.loaders.dataset_mode = "aligned"
    c.loaders.preprocess = "resize_and_crop"
    g = c.model.G
    g.netG = "unet_256"
    g.input_nc = 1
    g.output_nc = 1
    g.ngf = 64
    g.norm = "batch"
    g.dropout = True
    g.init_type = "normal"
    g.init_gain = 0.02

    d = c.model.D
    d.netD = "basic"
    d.input_nc = 2
    d.ndf = 64
    d.norm = "batch"
    d.n_layers = 3
    d.init_type = "normal"
    d.init_gain = 0.02
