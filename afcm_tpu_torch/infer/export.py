"""Serving export of the port (``afcm_tpu/infer/export.py``): the EMA eval
step saved as a self-contained ``torch.export`` artifact that a serving
process loads and calls, with no model code, config tree or checkpoint on
the serving side.

The artifact is an ``ExportedProgram`` saved with ``torch.export.save``
(``<run_dir>/serving.pt2`` by default) and run through its ``.module()``,
with no compiler. It holds the whole step the predictor drives: the
optional uint8 ingest normalized in the graph (``tpu.transfer_dtype``), the
EMA generator with const noise, the optional reduced-precision fetch
(``tpu.fetch_dtype``), and the weights (optionally stored as bf16 and cast
back to float32 in the graph). Every filtered_lrelu call stays one node of
the custom operator ``afcm_tpu_torch::filtered_lrelu``, so an artifact
exported on the card launches kernel K1 as the in-process forward does;
importing ``afcm_tpu_torch.ops`` (this module does) registers the operators
before an artifact is loaded. Like the JAX export (``:123-134``) the
artifact is the float model: the int8 conv route is unpinned while tracing.

z differs from the JAX artifact's. ``torch.export`` cannot hold a
``torch.Generator``, and a ``torch.randn`` in the graph would draw from the
process's global generator, so z [N, z_dim] is an input of the artifact,
where the JAX artifact takes a call counter and folds it into its key.
``serving_forward`` draws z from a ``torch.Generator`` on the serving
device, seeded with ``seed``, one draw per batch: the stream of
``evaluate.make_forward_fn``'s per-batch mode, so a volume served from the
artifact equals the in-process one for the same seed.

CLI (writes <run_dir>/serving.pt2 by default; runs on the card unless
``--device cpu``):

    python -m afcm_tpu_torch.infer.export --config-file configs/adni/stylegan3/cmsr.yml \\
        [--output PATH] [--symbolic-batch] [--weights-dtype bfloat16] [--device cpu] \\
        [epoch latest] [KEY VALUE ...]

Serving side (``python -m afcm_tpu_torch.serve --artifact PATH``):

    forward = serving_forward("serving.pt2")      # (a, slice_idx) -> fake_B
    predictor = StandardPredictor(forward, out_dir, cfg)
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..evaluate import fetch_dtype_or_none, mesh_forward, normalize_uint8
from ..models.gan_model import GANModel, eval_forward
from ..ops import get_conv_impl, set_conv_impl   # registers the operators
from ..parallel import local_batch_size

_INFO_FILE = "afcm_serving.json"
# the mesh's data axis rides on the ExportedProgram object until it is saved
_DEVICES_ATTR = "afcm_mesh_devices"


class _EvalStep(nn.Module):
    """``eval_forward`` of one generator, as a module whose state is the
    generator's."""

    def __init__(self, generator: nn.Module, c_dim: int):
        super().__init__()
        self.generator = generator
        self.c_dim = c_dim

    def forward(self, a, slice_idx, z):
        return eval_forward(self.generator, self.c_dim, a, slice_idx, z)


class ServingStep(nn.Module):
    """The serving computation ``(a, slice_idx, z) -> fake_B`` with the EMA
    generator's weights as its own buffers (in ``weights_dtype`` if given,
    cast to float32 in the graph)."""

    def __init__(self, model: GANModel, norm_range=None, fetch_dtype=None,
                 weights_dtype=None):
        super().__init__()
        # held outside the module tree: the weights below replace its own
        self._step = [_EvalStep(model.generator_ema, model.c_dim)]
        self.norm_range = (None if norm_range is None else
                           (float(norm_range[0]), float(norm_range[1])))
        self.out_dtype = fetch_dtype_or_none(fetch_dtype)
        weights_dtype = None if weights_dtype is None else getattr(torch, weights_dtype)
        self.names = []
        state = dict(self._step[0].named_parameters())
        state.update(self._step[0].named_buffers())
        for idx, (name, t) in enumerate(state.items()):
            t = t.detach()
            if weights_dtype is not None and t.dtype == torch.float32:
                t = t.to(weights_dtype)
            self.register_buffer(f"w{idx}", t)
            self.names.append(name)

    def forward(self, a, slice_idx, z):
        if self.norm_range is not None:
            a = normalize_uint8(a, *self.norm_range)
        weights = {name: getattr(self, f"w{idx}").float()
                   for idx, name in enumerate(self.names)}
        out = torch.func.functional_call(self._step[0], weights, (a, slice_idx, z))
        return out if self.out_dtype is None else out.to(self.out_dtype)


def make_eval_fn(model: GANModel, *, norm_range=None, fetch_dtype=None,
                 weights_dtype=None) -> ServingStep:
    """The serving computation ``fn(a, slice_idx, z) -> fake_B`` as a module
    (the JAX function's ``counter`` is z here; see the module docstring)."""
    return ServingStep(model, norm_range, fetch_dtype, weights_dtype)


def export_eval(model: GANModel, batch_size: Optional[int], img_shape: Sequence[int],
                *, norm_range=None, fetch_dtype=None, weights_dtype=None, mesh=None):
    """Export the EMA eval step for a fixed ``batch_size`` (the predictor
    pads ragged tails to the loader's batch size); ``batch_size=None``
    exports a symbolic batch dimension, one artifact for any batch size.
    With a ``mesh`` the artifact records its data axis's device count and
    serves over that many devices (``serving_forward``); its graph is the
    one-device step on each device's chunk, ``batch_size`` / devices.
    ``img_shape`` is the conditioning window (C, H, W); with ``norm_range``
    the artifact ingests uint8 and normalizes in the graph, else float32 in
    [-1, 1]. ``weights_dtype="bfloat16"`` stores the floating weights as
    bf16, about half the file. The trace runs on the device of the model's
    weights, with the float conv (conv impl ``xla``), and the process's conv
    setting is restored whatever happens."""
    # over a model axis too, the artifact is split by batch over the data
    # axis with whole weights, as afcm_tpu/infer/export.py:117-121 exports it
    devices = 1 if mesh is None else mesh.shape["data"]
    device = next(model.generator_ema.parameters()).device
    step = make_eval_fn(model, norm_range=norm_range, fetch_dtype=fetch_dtype,
                        weights_dtype=weights_dtype).eval()
    # each device of the mesh runs the graph on its chunk of the batch
    n = local_batch_size(batch_size, devices) if batch_size else 2
    gen = torch.Generator().manual_seed(0)
    if norm_range is not None:
        a = torch.randint(0, 256, (n, *img_shape), generator=gen, dtype=torch.uint8)
    else:
        a = torch.rand((n, *img_shape), generator=gen) * 2 - 1
    args = (a.to(device), torch.rand((n, 1), generator=gen).to(device),
            torch.randn((n, model.z_dim), generator=gen).to(device))
    dynamic = None
    if batch_size is None:
        batch = torch.export.Dim("batch", min=1)
        dynamic = ({0: batch}, {0: batch}, {0: batch})
    old = get_conv_impl()
    set_conv_impl("xla")
    try:
        with torch.no_grad():
            exported = torch.export.export(step, args, dynamic_shapes=dynamic)
    finally:
        set_conv_impl(old)
    setattr(exported, _DEVICES_ATTR, devices)
    return exported


def mesh_devices(exported) -> int:
    """The data axis the artifact was exported over (1 without a mesh)."""
    return getattr(exported, _DEVICES_ATTR, 1)


def exported_device_type(exported) -> str:
    """The device type the weights of an ExportedProgram lie on."""
    return next(iter(exported.state_dict.values())).device.type


def count_nodes(exported, op_name: str = "filtered_lrelu") -> int:
    """Nodes of the graph that call ``afcm_tpu_torch::<op_name>``."""
    target = getattr(torch.ops.afcm_tpu_torch, op_name).default
    return sum(1 for node in exported.graph.nodes if node.target is target)


def save_exported(exported, path: str) -> str:
    """``torch.export.save`` with the device type the artifact was exported
    on, written atomically: a kill mid-write leaves no truncated artifact."""
    info = {"device": exported_device_type(exported), "devices": mesh_devices(exported)}
    tmp = f"{path}.tmp{os.getpid()}.pt2"
    torch.export.save(exported, tmp, extra_files={_INFO_FILE: json.dumps(info)})
    os.replace(tmp, path)
    return path


def load_exported(path: str):
    """(ExportedProgram, the device type it was exported on)."""
    extra = {_INFO_FILE: ""}
    exported = torch.export.load(path, extra_files=extra)
    info = json.loads(extra[_INFO_FILE]) if extra[_INFO_FILE] else {}
    setattr(exported, _DEVICES_ATTR, int(info.get("devices", 1)))
    return exported, info.get("device", exported_device_type(exported))


def _input_specs(exported):
    """(dtype, shape) of each user input of the graph: a, slice_idx, z."""
    placeholders = {node.name: node for node in exported.graph.nodes
                    if node.op == "placeholder"}
    specs = []
    for spec in exported.graph_signature.input_specs:
        if spec.kind == torch.export.graph_signature.InputKind.USER_INPUT:
            val = placeholders[spec.arg.name].meta["val"]
            specs.append((val.dtype, tuple(val.shape)))
    return specs


def replica_module(exported, device) -> nn.Module:
    """The artifact's module on ``device``: the program as it is where its
    weights lie, else a copy moved there by ``move_to_device_pass`` (its
    weights, constants and the devices its graph names)."""
    from torch.export.passes import move_to_device_pass
    home = next(iter(exported.state_dict.values())).device
    device = torch.device(device)
    if device.type == home.type and device.index in (None, home.index):
        return exported.module()
    return move_to_device_pass(exported, device).module()


def serving_forward(exported_or_path, seed: int = 0, device=None, mesh=None):
    """The artifact as the ``(a_batch, slice_idx)`` callable
    ``StandardPredictor`` drives: batches go to the artifact's device, z is
    drawn per batch from a ``torch.Generator`` there seeded with ``seed``,
    and the result stays on the device (``evaluate.DeviceResult``). An
    artifact exported over a mesh serves over a ``mesh`` with as many
    devices on its data axis, one replica of its module on each, each batch
    split over them (``evaluate.mesh_forward``; ``afcm_tpu/serve.py:43-51``).
    Raises when ``device`` is not of the type the artifact was exported on,
    when the mesh's size is not the artifact's, and when a batch's dtype is
    not the artifact's ingest dtype."""
    if isinstance(exported_or_path, (str, os.PathLike)):
        exported, device_type = load_exported(exported_or_path)
    else:
        exported = exported_or_path
        device_type = exported_device_type(exported)
    want = mesh_devices(exported)
    got = 1 if mesh is None else mesh.shape["data"] * mesh.shape["model"]
    if got != want:
        raise ValueError(f"the artifact was exported over {want} device(s); it "
                         f"cannot serve over {got}")
    if mesh is not None and want > 1:
        device = mesh.data_devices[0]
    else:
        mesh = None
    device = torch.device(device or device_type)
    devices = [device] if mesh is None else mesh.data_devices
    if any(d.type != device_type for d in devices):
        raise ValueError(f"the artifact was exported on {device_type}; it cannot "
                         f"serve on {device}: export it again on that device")
    (a_dtype, _), _, (_, z_shape) = _input_specs(exported)
    z_dim = int(z_shape[1])
    modules = {}
    for d in devices:
        if d not in modules:
            modules[d] = replica_module(exported, d)
    rng = torch.Generator(device=device)
    rng.manual_seed(seed)

    def run(i, a, s, z):
        with torch.no_grad():
            return modules[devices[i]](a, s, z)

    def forward(a_batch, slice_idx):
        a = torch.from_numpy(np.ascontiguousarray(a_batch))
        if a.dtype != a_dtype:
            raise TypeError(
                f"artifact expects {a_dtype} patches but got {a.dtype}: the "
                "export's ingest mode (uint8 vs float) must match what the loader "
                "ships; export again with the matching tpu.transfer_dtype (e.g. "
                "'tpu.transfer_dtype float32')")
        s = torch.from_numpy(np.asarray(slice_idx, np.float32))
        z = torch.randn((a.shape[0], z_dim), generator=rng, device=device)
        return mesh_forward(run, device, a, s, z, mesh)
    return forward


def main(argv=None):
    # The config layer needs yaml; only the CLIs import it.
    from ..config import default_argument_parser, pop_flag
    from ..evaluate import (checkpoint_tag, configure_numerics, detect_norm_range,
                            ensure_volumetric, load_generator_ema, resolve_device)
    from ..models import build_eval_model, check_model_name

    argv = list(sys.argv[1:] if argv is None else argv)
    output = pop_flag(argv, "--output")
    symbolic = pop_flag(argv, "--symbolic-batch", has_value=False)
    weights_dtype = pop_flag(argv, "--weights-dtype")
    device = resolve_device(pop_flag(argv, "--device"))
    cfg = default_argument_parser(argv)
    ensure_volumetric(cfg, "afcm_tpu_torch.infer.export")
    check_model_name(cfg)
    try:
        compute_dtype = configure_numerics(cfg)
        model = build_eval_model(dict(cfg.model.G), compute_dtype=compute_dtype)
        run_dir = os.path.join(cfg.checkpoints_dir, cfg.name)
        tag = checkpoint_tag(cfg)
        load_generator_ema(model, run_dir, tag)
        model.generator_ema.to(device)
        # uint8 ingest only where every test volume ships as bytes
        norm_range = detect_norm_range(cfg)
        batch = None if symbolic else int(cfg.loaders.batch_size)
        res = cfg.model.G.img_resolution
        exported = export_eval(model, batch, (cfg.model.G.img_channels_in, res, res),
                               norm_range=norm_range,
                               fetch_dtype=getattr(cfg.tpu, "fetch_dtype", None),
                               weights_dtype=weights_dtype)
    finally:
        set_conv_impl("xla")    # the knob is this run's, not the process's
    output = output or os.path.join(run_dir, "serving.pt2")
    save_exported(exported, output)
    print(f"exported {tag} eval step (batch {batch or 'symbolic'}, "
          f"{'uint8' if norm_range else 'float32'} ingest, {device.type}, "
          f"{count_nodes(exported)} filtered_lrelu nodes) -> {output} "
          f"[{os.path.getsize(output) / 1e6:.1f} MB]")
    return output


if __name__ == "__main__":
    main()
