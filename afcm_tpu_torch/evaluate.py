"""Evaluation entry point of the port (``afcm_tpu/evaluate.py:131-354``).

    python -m afcm_tpu_torch.evaluate --config-file configs/adni/stylegan3/cmsr.yml \
        [--device cpu] [epoch latest] [KEY VALUE ...]

Loads ``<checkpoints_dir>/<name>/<tag>_net_G_ema.pth`` (a torch state_dict
under the reference's file naming), runs the patch-stitched predictor per
test subject with the EMA generator on the device, and reports 3-D and
per-slice PSNR/SSIM into ``evaluate.txt``. It runs on the CUDA device and
raises when there is none, unless ``--device cpu`` asks for the CPU (where
every kernel's plain version runs). ``tpu.conv_int8 True`` routes the gated
3x3 convs through the int8 conv kernel (``ops/cuda/conv_int8.py``);
``tpu.fetch_dtype bfloat16`` rounds each prediction batch on the device so
that the copy to the host moves half the bytes. ``tpu.mesh_shape [D, M]``
with M > 1 serves over D·M ranks (``serve_over_model_axis``): rank 0 reads,
draws z and stitches; each data row runs its contiguous chunk of every
batch through its slices of G_ema (``parallel/tensor.py``).
"""

from __future__ import annotations

import glob
import os
import sys
import tempfile
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from . import parallel
from .data import get_test_loaders
from .data.h5_dataset import _is_standard_pipeline
from .infer.predictor import StandardPredictor, subject_id
from .models import GANModel, build_eval_model, check_model_name
from .models.gan_model import eval_forward
from .ops.modulated_conv import set_conv_impl
from .utils.metrics import evaluate_3D, evaluate_slice
from .utils.nifti import read_nifti, write_nifti
from .utils.profiling import span


def normalize_uint8(a, lo: float, hi: float):
    """Normalize -> [-1, 1] of a uint8 batch on its device: the formula the
    host float path applies (data/h5_dataset.py AbstractVolumeDataset._norm)."""
    return torch.clamp(2 * ((a.float() - lo) / (hi - lo)) - 1, -1, 1)


class DeviceResult:
    """A forward result left on the device, with the two duck types
    ``StandardPredictor`` relies on (``infer/predictor.py:214-231``):
    ``copy_to_host_async()`` starts a non-blocking copy into pinned host
    memory and records a CUDA event; ``__array__`` waits on that event."""

    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor
        self._host: Optional[torch.Tensor] = None
        self._event: Optional[torch.cuda.Event] = None

    def copy_to_host_async(self):
        if self._host is not None:
            return
        if not self.tensor.is_cuda:
            self._host = self.tensor
            return
        self._host = torch.empty(self.tensor.shape, dtype=self.tensor.dtype,
                                 pin_memory=True)
        self._host.copy_(self.tensor, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()

    def __array__(self, dtype=None, copy=None):
        self.copy_to_host_async()
        if self._event is not None:
            self._event.synchronize()
        host = self._host
        if host.dtype == torch.bfloat16:    # numpy has no bf16; widening is exact
            host = host.float()
        arr = host.numpy()
        return arr if dtype is None else arr.astype(dtype, copy=False)


class MeshResult:
    """The results of one batch served over a mesh, one ``DeviceResult``
    per device in batch order: ``copy_to_host_async()`` starts every copy,
    ``__array__`` joins them."""

    def __init__(self, parts):
        self.parts = parts

    def copy_to_host_async(self):
        for part in self.parts:
            part.copy_to_host_async()

    def __array__(self, dtype=None, copy=None):
        return np.concatenate([part.__array__(dtype) for part in self.parts])


def mesh_forward(run, device, a, s, z, mesh=None):
    """One patch batch (host tensors ``a``, ``s`` and the whole batch's
    ``z``) through ``run(replica_index, a, s, z) -> tensor``: on ``device``,
    or, over a ``mesh`` of several devices, cut into one contiguous chunk
    per device of its data axis, every chunk launched on its device before
    any is waited on. The copies to the devices run in the span
    ``afcm.serve.h2d``. Returns a ``DeviceResult``, or a ``MeshResult``."""
    with span("afcm.serve.h2d"):
        placed = ([a.to(device), s.to(device)] if mesh is None
                  else parallel.shard_batch({"a": a, "s": s, "z": z}, mesh))
    if mesh is None:
        # popped, so that ``run`` holds the only reference to the batch on
        # the device and frees it once normalized, before the forward's peak
        return DeviceResult(run(0, placed.pop(0), placed.pop(0), z))
    return MeshResult([DeviceResult(run(i, c["a"], c["s"], c["z"]))
                       for i, c in enumerate(placed)])


class ModelAxisServer:
    """Serving over the D·M ranks of a mesh with a model axis
    (``afcm_tpu/evaluate.py:148-201`` under ``shard_params``). Every rank
    builds the config's G_ema, loads its checkpoint whole and keeps its
    slices (``parallel.shard_module``). Rank 0 sends each batch (the inputs
    normalized, the whole batch's z) to every rank; each data row serves its
    contiguous chunk of it, as ``mesh_forward`` splits a batch over the data
    axis, its model ranks together; the chunks come back to rank 0. Each
    exchange is one all-reduce over every rank of the values placed in
    zeros, counted in the data group's census (``serve_header``,
    ``serve_batch``, ``serve_result``). The other ranks run ``serve`` until
    rank 0 calls ``close``."""

    def __init__(self, cfg, device):
        import torch.distributed as dist
        check_model_name(cfg)
        self.compute_dtype = configure_numerics(cfg)
        self.device = torch.device(device)
        self.model = build_eval_model(dict(cfg.model.G), compute_dtype=self.compute_dtype)
        self.run_dir = os.path.join(cfg.checkpoints_dir, cfg.name)
        load_generator_ema(self.model, self.run_dir, checkpoint_tag(cfg))
        self.model.generator_ema.to(self.device)
        self.group, self.model_group = parallel.make_groups(model_axis(cfg))
        parallel.shard_module(self.model.generator_ema, self.model_group)
        self.lead = dist.get_rank() == 0
        self.world = dist.group.WORLD

    def _from_lead(self, tensor: torch.Tensor, purpose: str) -> torch.Tensor:
        if not self.lead:
            tensor.zero_()
        return self.group._all_reduce(tensor, purpose, self.world)

    def _exchange(self, a=None, s=None, z=None) -> Optional[torch.Tensor]:
        """One batch through every rank (None: the stop). Returns the whole
        batch's output on rank 0."""
        header = torch.zeros(5, dtype=torch.float64, device=self.device)
        if a is not None:
            header[:] = torch.tensor((*a.shape, s.reshape(len(s), -1).shape[1]),
                                     dtype=torch.float64)
        n, c, h, w, s_cols = (int(v) for v in
                              self._from_lead(header, "serve_header").tolist())
        if n == 0:
            return None
        sizes = (n * c * h * w, n * s_cols, n * self.model.z_dim)
        flat = torch.empty(sum(sizes), dtype=torch.float32, device=self.device)
        if self.lead:
            flat.copy_(torch.cat([a.float().reshape(-1), s.float().reshape(-1),
                                  z.float().reshape(-1)]))
        a, s, z = self._from_lead(flat, "serve_batch").split(sizes)
        rows = self.group.rows(n // self.group.world)
        a = a.view(n, c, h, w)[rows]
        with torch.inference_mode():
            out = eval_forward(self.model.generator_ema, self.model.c_dim, a,
                               s.view(n, -1)[rows], z.view(n, -1)[rows])
        whole = torch.zeros((n, *out.shape[1:]), dtype=torch.float32, device=self.device)
        if self.model_group.rank == 0:
            whole[rows] = out.float()
        whole = self.group._all_reduce(whole, "serve_result", self.world)
        return whole.to(out.dtype)

    def forward(self, a, s, z) -> torch.Tensor:
        """Rank 0: one batch (on its device) through the mesh."""
        parallel.local_batch_size(a.shape[0], self.group.world)  # raises if it does not divide
        return self._exchange(a, s, z)

    def serve(self) -> None:
        """The other ranks: serve until rank 0 stops."""
        while self._exchange() is not None:
            pass

    def close(self) -> None:
        """Rank 0: stop the other ranks."""
        self._exchange()


def _serving_rank(rank: int, world: int, argv, device_type: str, run: Callable,
                  run_args: Sequence, result_path: str) -> None:
    """One rank of ``serve_over_model_axis``: rank 0 runs ``run(cfg,
    device, *run_args, server=)`` and saves what it returns, the others
    serve its batches."""
    from .config import default_argument_parser
    cfg = default_argument_parser(list(argv))
    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    server = ModelAxisServer(cfg, device)
    if not server.lead:
        return server.serve()
    try:
        result = run(cfg, device, *run_args, server=server)
    finally:
        server.close()
    torch.save(result, result_path)


def serve_over_model_axis(run: Callable, run_args: Sequence, cfg, argv,
                          device) -> object:
    """Run a serving entry point (``run(cfg, device, *run_args, server=)``)
    over the D·M ranks of the config's mesh, NCCL on the cards, gloo on the
    CPU; returns what rank 0's ``run`` returned."""
    mesh = parallel.resolve_mesh(cfg.tpu.mesh_shape, cfg.loaders.batch_size, device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    print(f"serving over {mesh.devices.size} ranks ({mesh.shape['data']} x "
          f"{mesh.shape['model']}) over {backend}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        result_path = os.path.join(tmp, "result.pt")
        parallel.spawn(_serving_rank, mesh.devices.size,
                       (list(argv), device.type, run, tuple(run_args), result_path),
                       backend=backend, init_file=os.path.join(tmp, "store"),
                       device_type=device.type)
        return torch.load(result_path, weights_only=False)


def fetch_dtype_or_none(fetch_dtype):
    """``tpu.fetch_dtype`` -> the dtype the output is cast to on the device
    before the copy to the host; None leaves it float32
    (``afcm_tpu/evaluate.py:46-49``)."""
    if fetch_dtype in (None, "float32"):
        return None
    if fetch_dtype != "bfloat16":
        raise ValueError(f"tpu.fetch_dtype {fetch_dtype!r}: float32 or bfloat16")
    return torch.bfloat16


def make_forward_fn(model: GANModel, device, seed: int = 0, norm_range=None,
                    eval_z: str = "per-batch", fetch_dtype=None, mesh=None,
                    server: Optional[ModelAxisServer] = None):
    """(A, slice_idx) numpy batch -> ``DeviceResult`` of the EMA generator.

    With a ``mesh`` of several devices (``prepare_mesh_state``) one replica
    of the EMA generator serves each device of its data axis and each batch
    is split over them (``mesh_forward``; ``afcm_tpu/evaluate.py:186-201``);
    z is drawn on the mesh's first device for the whole batch. With a
    ``server`` (rank 0 of a mesh with a model axis) each batch goes through
    ``ModelAxisServer.forward`` and ``model`` is the server's.

    ``eval_z="per-batch"`` draws a fresh z for every batch from one seeded
    ``torch.Generator`` (the reference protocol, comodgan_model.py:101-108);
    ``"fixed"`` draws z once and reuses it, i.e. one z per batch position
    for the whole run — the JAX package's behaviour, kept as it is (ROADMAP
    fault C1; fixed in both packages together). uint8 batches are normalized
    on the device with ``norm_range``. ``fetch_dtype="bfloat16"`` rounds the
    prediction batch on the device (``afcm_tpu/evaluate.py:217-232``); the
    predictor accumulates float32 either way."""
    if eval_z not in ("per-batch", "fixed"):
        raise ValueError(f"eval_z {eval_z!r}")
    if mesh is not None and mesh.devices.size > 1:
        replicas = parallel.replicate_state(model.generator_ema, mesh)
        device = mesh.data_devices[0]
    else:
        mesh, replicas = None, [model.generator_ema]
    device = torch.device(device)
    out_dtype = fetch_dtype_or_none(fetch_dtype)
    rng = torch.Generator(device=device)
    rng.manual_seed(seed)
    fixed_z = {}

    def z_of(n):
        if eval_z == "fixed":
            if n not in fixed_z:
                fixed_z[n] = torch.randn((n, model.z_dim), generator=rng,
                                         device=device)
            return fixed_z[n]
        return torch.randn((n, model.z_dim), generator=rng, device=device)

    def run(i, a, s, z):
        with span("afcm.serve.g_ema"):
            if a.dtype == torch.uint8:
                a = normalize_uint8(a, float(norm_range[0]), float(norm_range[1]))
            if server is not None:
                out = server.forward(a, s, z)
            else:
                with torch.inference_mode():
                    out = eval_forward(replicas[i], model.c_dim, a, s, z)
            return out if out_dtype is None else out.to(out_dtype)

    def forward(a_batch, slice_idx):
        a = torch.from_numpy(np.ascontiguousarray(a_batch))
        if a.dtype == torch.uint8 and norm_range is None:
            raise ValueError("uint8 batches require make_forward_fn(norm_range=...)")
        s = torch.from_numpy(np.asarray(slice_idx, np.float32))
        return mesh_forward(run, device, a, s, z_of(a.shape[0]), mesh)
    return forward


def set_matmul_precision(compute_dtype: str) -> None:
    """TF32 off for cuDNN convolutions and matmuls in float32, on otherwise:
    the analog of ``tpu.matmul_precision highest`` (docs/porting.md:46-53)."""
    tf32 = compute_dtype != "float32"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA device when none is named. The port runs on
    the card: without one it raises unless the caller asked for the CPU."""
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device; pass --device cpu to "
                           "run on the CPU")
    return device


def model_axis(cfg) -> int:
    """The model axis of the config's mesh (``tpu.mesh_shape [D, M]``).
    Over more than 1 every GAN (StyleGAN3, CoModGAN, StyleGAN-V) shards
    its networks (``parallel/tensor.py``) and pix2pix runs its whole state
    on every rank, as ``afcm_tpu`` runs them (``afcm_tpu/train.py:111-120``,
    ``afcm_tpu/evaluate.py:148-167``: any state with a G_ema shards)."""
    return max(int(cfg.tpu.mesh_shape[1]), 1)


FILTERED_LRELU_IMPLS = ("xla", "pallas", "auto")


def check_device_knobs(cfg) -> None:
    """One line for a ``tpu.matmul_precision`` other than ``default``: the
    port sets TF32 from ``tpu.compute_dtype`` alone. ``tpu.filtered_lrelu_impl``
    must be one of ``FILTERED_LRELU_IMPLS``, as ``afcm_tpu``'s
    ``set_default_impl`` asserts; ``pallas`` and ``auto`` get one line,
    since a CUDA tensor always takes the CUDA kernel and the TPU's routing
    is not ported."""
    if cfg.tpu.matmul_precision != "default":
        print(f"tpu.matmul_precision {cfg.tpu.matmul_precision} has no effect: the "
              "port sets TF32 from tpu.compute_dtype alone (off for float32)")
    impl = getattr(cfg.tpu, "filtered_lrelu_impl", "xla")
    if impl not in FILTERED_LRELU_IMPLS:
        raise ValueError(f"tpu.filtered_lrelu_impl {impl!r}: one of "
                         f"{', '.join(FILTERED_LRELU_IMPLS)}")
    if impl != "xla":
        print(f"tpu.filtered_lrelu_impl {impl} has no effect: a CUDA tensor always "
              "takes the CUDA filtered_lrelu kernel; the TPU's routing is not ported")


def configure_numerics(cfg) -> str:
    """Check the config's device knobs for serving (``check_device_knobs``),
    set the conv implementation from ``tpu.conv_int8``
    (``afcm_tpu/evaluate.py:138-142``) and the matmul precision of
    ``tpu.compute_dtype``, and return the compute dtype."""
    check_device_knobs(cfg)
    fetch_dtype_or_none(getattr(cfg.tpu, "fetch_dtype", None))     # raises on a bad value
    if getattr(cfg.tpu, "conv_int8", False):
        set_conv_impl("int8", getattr(cfg.tpu, "conv_int8_variant", "dots"),
                      getattr(cfg.tpu, "conv_int8_min_ch", 64))
        print("conv: int8 kernel routing enabled")
    else:
        set_conv_impl("xla")
    compute_dtype = cfg.tpu.compute_dtype
    set_matmul_precision(compute_dtype)
    if compute_dtype == "float32":
        print("compute_dtype float32: TF32 off for cuDNN convolutions and matmuls")
    return compute_dtype


def pipeline_norm_range(cfg):
    """The Normalize range when ``tpu.transfer_dtype`` is uint8 and the test
    pipeline is the standard Normalize->ToTensor chain, else None
    (``afcm_tpu/evaluate.py:72-83``)."""
    if getattr(cfg.tpu, "transfer_dtype", "float32") != "uint8":
        return None
    return _is_standard_pipeline(cfg.loaders.test.transformer.raw)


def detect_norm_range(cfg):
    """Strict ingest decision for the serving export (the port's copy of
    ``afcm_tpu/evaluate.py:86-128``): an artifact has one ingest dtype, so
    uint8 is chosen only when every test volume will ship as bytes, checked
    from the h5 metadata (dtype reads, no volume data; h5py is imported only
    here). Mixed or non-uint8 storage falls back to float ingest with a
    printed note; with no test data reachable, or the NII cascade (whose
    loader bins volumes to uint8), the config's range is assumed and noted."""
    rng = pipeline_norm_range(cfg)
    if rng is None:
        return None
    if cfg.loaders.get("dataset_mode", "cmsr") != "cmsr":
        return rng
    from .data.h5_dataset import StandardHDF5Dataset
    try:
        files = StandardHDF5Dataset.traverse_paths(
            list(cfg.loaders.test.file_paths), cfg.loaders)
    except (OSError, TypeError):
        files = []
    if not files:
        print("export note: no test volumes reachable — assuming uint8 "
              f"storage (config Normalize range {tuple(rng)}); re-export "
              "with `tpu.transfer_dtype float32` if the data is not uint8.")
        return rng
    import h5py
    keys = list(dict.fromkeys(list(cfg.loaders.raw_internal_path_in) +
                              list(cfg.loaders.raw_internal_path_out)))
    for path in files:
        try:
            with h5py.File(path, "r") as f:
                dtypes = {f[k].dtype for k in keys if k in f}
        except OSError as exc:
            print(f"export note: cannot read {path} ({exc}); "
                  "falling back to float32 ingest.")
            return None
        if dtypes != {np.dtype(np.uint8)}:
            print(f"export note: {path} stores {sorted(map(str, dtypes))} "
                  "(not uint8) — the loader will ship float batches, so "
                  "the artifact uses float32 ingest.")
            return None
    return rng


def checkpoint_tag(cfg) -> str:
    return str(cfg.epoch) if cfg.epoch else "latest"


def load_generator_ema(model: GANModel, run_dir: str, tag: str):
    """Load ``<tag>_net_G_ema.pth`` strictly into the EMA generator."""
    path = os.path.join(run_dir, f"{tag}_net_G_ema.pth")
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.generator_ema.load_state_dict(state, strict=True)


def ensure_volumetric(cfg, entry_point: str) -> None:
    """The volumetric predictor flow has no meaning for the pix2pix
    image-folder baseline (``afcm_tpu/evaluate.py:168-177``)."""
    if getattr(cfg.model, "name", "stylegan3") == "pix2pix":
        raise NotImplementedError(
            f"{entry_point} is the volumetric predictor flow; the pix2pix "
            "image-folder baseline is trained/validated via the train CLI "
            "(PSNR/SSIM on the val split), matching the reference's scope.")


def serving_mesh(mesh_shape, batch_size: int, device) -> Optional[parallel.Mesh]:
    """The mesh the serving CLIs serve over. A data axis the config sets
    (``tpu.mesh_shape [N, 1]``, ``--num-gpus N``) is taken, clamped to a
    divisor of the batch. The default data axis 0 serves on one device,
    where ``afcm_tpu`` takes every device: one host thread launches every
    replica's chunk, and split over four cards the default batch was served
    slower than on one (PERF.md, §6). Training keeps every card."""
    if int(mesh_shape[0]) <= 0:
        return None
    return parallel.resolve_mesh(mesh_shape, batch_size, device)


def prepare_mesh_state(cfg, model: GANModel, device):
    """The serving mesh of the config (``serving_mesh``;
    ``afcm_tpu/evaluate.py:148-165``) over the cards, or over the CPU for
    ``--device cpu``, and the EMA generator's weights moved to ``device``
    once. Returns the mesh, or None for one device;
    ``make_forward_fn(mesh=)`` replicates the generator."""
    model.generator_ema.to(device)
    return serving_mesh(cfg.tpu.mesh_shape, cfg.loaders.batch_size, device)


def build_serving_forward(cfg, device, server: Optional[ModelAxisServer] = None):
    """What the evaluate and serve CLIs share: set the numerics of the
    config (the caller resets the conv implementation when it ends), build
    the model, load ``<tag>_net_G_ema.pth`` strictly, move the weights to
    the device (or each device of the config's mesh) once and return
    ``(forward, run_dir)``. With a ``server`` (rank 0 over a model axis)
    the server holds the model and serves each batch over the mesh."""
    if server is not None:
        model, run_dir, mesh = server.model, server.run_dir, None
    else:
        check_model_name(cfg)
        compute_dtype = configure_numerics(cfg)
        model = build_eval_model(dict(cfg.model.G), compute_dtype=compute_dtype)
        run_dir = os.path.join(cfg.checkpoints_dir, cfg.name)
        load_generator_ema(model, run_dir, checkpoint_tag(cfg))
        mesh = prepare_mesh_state(cfg, model, device)
    forward = make_forward_fn(model, device,
                              norm_range=pipeline_norm_range(cfg),
                              eval_z=getattr(cfg.tpu, "eval_z", "per-batch"),
                              fetch_dtype=getattr(cfg.tpu, "fetch_dtype", None),
                              mesh=mesh, server=server)
    return forward, run_dir


def find_target_volume(ori_file_path: Optional[str], modality: str,
                       subject: str) -> Optional[np.ndarray]:
    """The registered original-resolution target of a subject, if any
    (``afcm_tpu/evaluate.py:255-270``)."""
    if ori_file_path and os.path.isdir(os.path.join(ori_file_path, subject)):
        matches = glob.glob(os.path.join(ori_file_path, subject,
                                         f"{subject}*{modality}.nii.gz"))
        if matches:
            vol, _ = read_nifti(matches[0])
            return np.asarray(vol, np.float64)
    return None


def serve_and_score(forward_fn, loaders, out_path: str, modality: str,
                    config=None, patch_halo=(0, 8, 8),
                    ori_file_path: Optional[str] = None):
    """Serve every subject of ``loaders`` through ``StandardPredictor`` with
    ``forward_fn`` and score the stitched volume against its target (the
    registered original under ``ori_file_path``, else the subject's own
    ``modality``); writes the predictions and appends one line per subject
    and the summary to ``<out_path>/evaluate.txt``
    (``afcm_tpu/evaluate.py:297-354``). Returns the mean scores and, under
    ``"subjects"``, each subject's scores, volume shape and finiteness."""
    predictor = StandardPredictor(forward_fn, out_path, config,
                                  patch_halo=patch_halo)
    subjects = {}
    with open(os.path.join(out_path, "evaluate.txt"), "a") as fw:
        # tpu.pipeline_depth batches stay in flight across subjects
        # (StandardPredictor.run_pipelined reads it from the config).
        for test_loader in predictor.run_pipelined(loaders):
            subject = subject_id(test_loader.dataset.file_path)
            volume = predictor.last_prediction
            img_data = (np.clip(volume, -1, 1) + 1) / 2

            target = find_target_volume(ori_file_path, modality, subject)
            if target is not None:
                target_data = np.clip(target, 0, 255) / 255
            else:
                target_data = test_loader.dataset.raw[modality].astype(
                    np.float64) / 255
            predictor.submit_write(
                write_nifti, os.path.join(out_path, subject + "_ori.nii.gz"),
                target_data.astype(np.float32))

            one = evaluate_3D(img_data, target_data)
            one_slice = evaluate_slice(img_data, target_data)
            subjects[subject] = {
                "psnr": one[0], "ssim": one[1], "psnr_slice": one_slice[0],
                "ssim_slice": one_slice[1], "shape": volume.shape,
                "finite": bool(np.isfinite(volume).all())}
            line = (f" subject:{subject}   psnr:{one[0]:.6}, ssim:{one[1]:.6}, "
                    f"psnr_slice:{one_slice[0]:.6}, ssim_slice:{one_slice[1]:.6}\n")
            fw.write(line)
            print(line, end="")

        c_psnr, c_ssim, c_psnr_slice, c_ssim_slice = (
            [scores[key] for scores in subjects.values()]
            for key in ("psnr", "ssim", "psnr_slice", "ssim_slice"))
        summary = (f" ^^^VALIDATION mean psnr:{np.mean(c_psnr):.6}, "
                   f"ssim:{np.mean(c_ssim):.6}, "
                   f"psnr_slice:{np.mean(c_psnr_slice):.6}, "
                   f"ssim_slice:{np.mean(c_ssim_slice):.6}\n")
        summary += (f" std   psnr:{np.std(c_psnr):.6}, ssim:{np.std(c_ssim):.6}, "
                    f"psnr_slice:{np.std(c_psnr_slice):.6}, "
                    f"ssim_slice:{np.std(c_ssim_slice):.6}\n")
        fw.write(summary)
        print(summary, end="")
    predictor.wait_for_writes()
    return {"psnr": float(np.mean(c_psnr)), "ssim": float(np.mean(c_ssim)),
            "psnr_slice": float(np.mean(c_psnr_slice)),
            "ssim_slice": float(np.mean(c_ssim_slice)), "subjects": subjects}


def main(argv=None):
    # The config layer needs yaml; only the CLIs import it.
    from .config import default_argument_parser, pop_flag

    argv = list(sys.argv[1:] if argv is None else argv)
    device = resolve_device(pop_flag(argv, "--device"))
    cfg = default_argument_parser(argv)
    print(cfg.dump())
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                 if device.type == "cuda" else ""))
    ensure_volumetric(cfg, "afcm_tpu_torch.evaluate")
    if model_axis(cfg) > 1:
        return serve_over_model_axis(score, (), cfg, argv, device)
    return score(cfg, device)


def score(cfg, device, server: Optional[ModelAxisServer] = None):
    """The evaluate CLI's run: serve and score the config's test subjects
    (``serve_and_score``) with the checkpoint's G_ema, in this process or,
    with a ``server``, over the mesh's model axis."""
    try:
        forward, run_dir = build_serving_forward(cfg, device, server)
        out_path = os.path.join(run_dir, "evaluate")
        os.makedirs(out_path, exist_ok=True)
        return serve_and_score(forward, get_test_loaders(cfg), out_path,
                               cfg.loaders.raw_internal_path_out[-1], config=cfg,
                               patch_halo=cfg.predictor.patch_halo,
                               ori_file_path=cfg.loaders.test.ori_file_path)
    finally:
        set_conv_impl("xla")    # the knob is this run's, not the process's


if __name__ == "__main__":
    main()
