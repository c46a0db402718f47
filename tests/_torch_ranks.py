"""Rank functions for tests/test_torch_parallel.py's gloo process groups.

Each runs in a fresh process that ``afcm_tpu_torch.parallel.spawn`` starts
and imports only torch, numpy and the port, so that a rank starts fast; the
test process holds the JAX side and compares. A rank writes what it
computed under ``out_dir`` as ``r{rank}_...pt``.
"""

import copy
import os

import numpy as np
import torch

from afcm_tpu_torch import parallel
from afcm_tpu_torch.utils import checkpoint as ckpt


def noise(shape):
    """The noise the CoModGAN steps add where a synthesis layer draws it: a
    numpy function of the shape (tests/test_torch_comodgan.py:_noise)."""
    shape = tuple(int(d) for d in shape)
    return np.random.RandomState(sum(shape) * 7 + shape[-1]).randn(*shape).astype(np.float32)


def _local(group, batch):
    return {k: torch.from_numpy(v[group.rows(len(v) // group.world)])
            for k, v in batch.items()}


def gan_steps(rank, world, model_path, steps, out_dir, replace_noise=False):
    """``GANModel.train_step`` on this rank's slice of each global batch;
    ``steps`` holds (batch, global z, cur_nimg, with_r1) per step. Writes
    (metrics, model, census) after each step."""
    model = torch.load(model_path, weights_only=False)
    group = parallel.DataGroup.current()
    model.distribute(group)
    if replace_noise:
        torch.randn = lambda shape, **kw: torch.from_numpy(noise(shape))
    for step, (batch, z, nimg, with_r1) in enumerate(steps, start=1):
        metrics = model.train_step(_local(group, batch), nimg, with_r1=with_r1,
                                   z=torch.from_numpy(z),
                                   generator=torch.Generator().manual_seed(step))
        torch.save((metrics, model, group.take_census()),
                   os.path.join(out_dir, f"r{rank}_s{step}.pt"))


def pix2pix_step(rank, world, model_path, batch, masks, alpha, out_dir):
    """``Pix2PixModel.train_step`` on this rank's slice, with the global
    batch's dropout masks and penalty weights."""
    model = torch.load(model_path, weights_only=False)
    group = parallel.DataGroup.current()
    model.distribute(group)
    metrics = model.train_step(_local(group, batch), dropout_masks=masks, gp_alpha=alpha)
    torch.save((metrics, model), os.path.join(out_dir, f"r{rank}_s1.pt"))


def resume(rank, world, argv, out_dir):
    """The save -> load -> resume round trip. (1) Rank 0 saves a model after
    one step, every rank loads it into a model built from other weights,
    and both models take the same next step; (2) the train loop resumes a
    run from its latest checkpoint, recording each step's ``cur_nimg`` and
    the step count it starts from."""
    from afcm_tpu_torch import train as train_cli
    from afcm_tpu_torch.config import default_argument_parser
    from afcm_tpu_torch.data.demo import phantom_train_loaders
    from afcm_tpu_torch.models import GANModel, build_model

    group = parallel.DataGroup.current()
    cfg = default_argument_parser(list(argv))
    rng = np.random.RandomState(5)
    batches = [{"A": rng.randn(2, 4, 64, 64).clip(-1, 1).astype(np.float32),
                "B": rng.randn(2, 1, 64, 64).clip(-1, 1).astype(np.float32),
                "slice_idx": rng.rand(2, 1).astype(np.float32)} for _ in range(2)]

    def step(model, i):
        return model.train_step(_local(group, batches[i]), 2.0 * (i + 1),
                                generator=torch.Generator().manual_seed(10 + i))

    run_dir = os.path.join(cfg.checkpoints_dir, "round_trip")
    first = build_model(cfg, generator=torch.Generator().manual_seed(0))
    first.distribute(group)
    step(first, 0)
    ckpt.save_state(first, run_dir, "mid", group)
    loaded = build_model(cfg, generator=torch.Generator().manual_seed(1))
    loaded.distribute(group)
    ckpt.load_state(loaded, run_dir, "mid")
    metrics = [step(model, 1) for model in (first, loaded)]

    loaders = phantom_train_loaders(depth=8, size=64, batch_size=2)
    train_cli.train(cfg, max_iters=4, loaders=loaders, device="cpu")
    seen = []
    real_step = GANModel.train_step

    def recording_step(self, batch, cur_nimg, **kwargs):
        seen.append((cur_nimg, self.step))
        return real_step(self, batch, cur_nimg, **kwargs)

    GANModel.train_step = recording_step
    resumed = default_argument_parser(list(argv) + ["continue_train", "True"])
    train_cli.train(resumed, max_iters=4, loaders=loaders, device="cpu")
    torch.save({"metrics": metrics, "models": (first, loaded), "resumed_steps": seen},
               os.path.join(out_dir, f"r{rank}_resume.pt"))


def statistics_and_penalty(x, w, group=None):
    """The minibatch std and a train-mode batch norm over the batch (the
    global one with a ``group``), a nonlinear head, and an R1-like penalty
    on its input gradient: the output, the gradient and the penalty's
    gradient, in float64."""
    from afcm_tpu_torch.nn.layers import MinibatchStdLayer
    from afcm_tpu_torch.nn.pix2pix import _Norm
    mbstd = MinibatchStdLayer(group_size=2)
    norm = _Norm(x.shape[1] + 1, "batch", generator=torch.Generator().manual_seed(0)).double()
    parallel.attach(mbstd, group)
    parallel.attach(norm, group)
    x = x.clone().requires_grad_(True)
    y = norm(mbstd(x))
    (g,) = torch.autograd.grad((torch.tanh(y) * w).sum(), x, create_graph=True)
    (gg,) = torch.autograd.grad(g.square().sum(), x)
    return y.detach(), g.detach(), gg


def collectives(rank, world, x, w, out_dir):
    """``statistics_and_penalty`` on this rank's rows of the global batch."""
    group = parallel.DataGroup.current()
    rows = group.rows(len(x) // world)
    torch.save(statistics_and_penalty(torch.from_numpy(x[rows]), torch.from_numpy(w[rows]),
                                      group), os.path.join(out_dir, f"r{rank}_stats.pt"))


def fails_or_waits(rank, world, failing_rank):
    """``failing_rank`` raises; every other rank waits for it at a barrier
    it never reaches (as a rank whose peer died would)."""
    if rank == failing_rank:
        raise ValueError(f"rank {rank} fails on purpose")
    parallel.DataGroup.current().barrier()


def sleeps(rank, world, seconds):
    """Outlasts the timeout it is started with."""
    import time
    time.sleep(seconds)


def step_check(rank, world, argv, batch, out_dir):
    """``parallel.check.train_step_check`` as this rank of the group."""
    from afcm_tpu_torch.config import default_argument_parser
    from afcm_tpu_torch.parallel.check import train_step_check
    result = train_step_check(default_argument_parser(list(argv)), batch, "cpu", seed=3,
                              draw_seed=4, group=parallel.DataGroup.current())
    torch.save(result, os.path.join(out_dir, f"r{rank}_check.pt"))


def host_utils(rank, world, values, out_dir):
    """``utils.training_stats.report_moments`` of this rank's rows of
    ``values`` summed over the group, and ``utils.misc.
    check_replica_consistency`` of one module across the ranks: equal, then
    with rank 1's bias moved. Writes (triple, census, first check, the
    mismatch's message)."""
    from afcm_tpu_torch.utils import misc, training_stats
    group = parallel.DataGroup.current()
    triple = training_stats.report_moments(
        torch.from_numpy(values[group.rows(len(values) // world)]), group)
    census = group.take_census()
    torch.manual_seed(0)
    net = torch.nn.Linear(3, 2)
    consistent = misc.check_replica_consistency(net)
    if rank == 1:
        with torch.no_grad():
            net.bias += 1
    try:
        misc.check_replica_consistency(net, group)
        mismatch = None
    except AssertionError as exc:
        mismatch = str(exc)
    torch.save((triple, census, consistent, mismatch),
               os.path.join(out_dir, f"r{rank}_host.pt"))


# -- tensor parallelism (tests/test_torch_tensor_parallel.py) ----------------------

NETS = ("generator", "discriminator", "generator_ema")


def _census(*groups):
    census = {}
    for group in groups:
        if group is not None:
            census.update(group.take_census())
    return census


def _whole(model, model_group):
    """Each net's state and each optimizer's state, whole again (copies:
    a state dict holds the live tensors)."""
    return copy.deepcopy((
        {net: parallel.full_state_dict(getattr(model, net), model_group) for net in NETS},
        {key: ckpt.full_optimizer_state(getattr(model, key), net, model_group)
         for key, net in (("opt_G", model.generator), ("opt_D", model.discriminator))}))


def tp_steps(rank, world, model_path, runs, out_dir, replace_noise=False):
    """For each (model_size, steps) of ``runs``: ``GANModel.train_step``
    from the pickled model over a mesh of world / model_size data rows of
    model_size ranks, on this row's slice of each global batch (with
    ``replace_noise``, every ``torch.randn`` gives ``noise`` of its shape);
    writes (metrics, whole nets, whole optimizer states, census) after each
    step as ``r{rank}_m{model_size}_s{step}.pt``."""
    if replace_noise:
        torch.randn = lambda shape, **kw: torch.from_numpy(noise(shape))
    for model_size, steps in runs:
        model = torch.load(model_path, weights_only=False)
        group, model_group = parallel.make_groups(model_size)
        model.distribute(group, model_group)
        for step, (batch, z, nimg, with_r1) in enumerate(steps, start=1):
            metrics = model.train_step(_local(group, batch), nimg, with_r1=with_r1,
                                       z=torch.from_numpy(z),
                                       generator=torch.Generator().manual_seed(step))
            census = _census(group, model_group)
            torch.save((metrics, *_whole(model, model_group), census),
                       os.path.join(out_dir, f"r{rank}_m{model_size}_s{step}.pt"))


def tp_checkpoint(rank, world, model_path, steps, out_dir):
    """Over a (1, world) mesh: one step, ``save_state``; a model built from
    the same file loads it (``load_state``); both take the next step.
    Writes the whole states after the save and after the next step."""
    group, model_group = parallel.make_groups(world)
    models = []
    for _ in range(2):
        model = torch.load(model_path, weights_only=False)
        model.distribute(group, model_group)
        models.append(model)
    first, loaded = models

    def step(model, i):
        batch, z, nimg, with_r1 = steps[i]
        return model.train_step(_local(group, batch), nimg, with_r1=with_r1,
                                z=torch.from_numpy(z),
                                generator=torch.Generator().manual_seed(i))

    step(first, 0)
    ckpt.save_state(first, os.path.join(out_dir, "ckpt"), "mid", group)
    saved = _whole(first, model_group)
    ckpt.load_state(loaded, os.path.join(out_dir, "ckpt"), "mid")
    metrics = [step(model, 1) for model in models]
    torch.save({"saved": saved, "metrics": metrics,
                "after": [_whole(model, model_group) for model in models]},
               os.path.join(out_dir, f"r{rank}_ckpt.pt"))


def stub_loader(depth, size, channels=4, batch_size=4, seed=0):
    """tests/test_parallel.py:207-236 at another size: ``depth``
    full-frame slices of a random volume in batches of ``batch_size``."""
    vol = np.random.RandomState(seed).randn(depth, size, size).astype(np.float32)

    class _Dataset:
        file_path = os.path.join(os.getcwd(), "subject.h5")
        raw = {"t1": vol}
        volume = vol
        slices = [(slice(0, 1), slice(i, i + 1), slice(0, size), slice(0, size))
                  for i in range(depth)]

        def __len__(self):
            return depth

        def get_item(self, i):
            a = np.repeat(vol[i][None], channels, axis=0)
            idx = (slice(i, i + 1), slice(0, size), slice(0, size))
            return a, np.asarray([i % 4 / 4.0], np.float32), idx

    class _Loader:
        dataset = _Dataset()

        def __init__(self):
            self.batch_size = batch_size

        def __iter__(self):
            ds = self.dataset
            for start in range(0, len(ds), self.batch_size):
                items = [ds.get_item(i) for i in range(start, min(start + self.batch_size,
                                                                   len(ds)))]
                yield (np.stack([x[0] for x in items]), np.stack([x[1] for x in items]),
                       [x[2] for x in items])

    return _Loader()


def stitched(forward, out_dir, loader):
    """The volume ``StandardPredictor`` stitches of ``loader`` with ``forward``."""
    from afcm_tpu_torch.infer.predictor import StandardPredictor
    from afcm_tpu_torch.utils.nifti import read_nifti
    predictor = StandardPredictor(forward, str(out_dir), None, patch_halo=(0, 0, 0))
    path = predictor(loader)
    predictor.wait_for_writes()
    return np.asarray(read_nifti(path)[0])


def tp_serve(rank, world, argv, batch, depth, out_dir):
    """``evaluate.ModelAxisServer`` over the config's mesh: rank 0 serves
    one batch (a, s, z) and stitches ``stub_loader(depth, ...)``'s volume
    (z from seed 3); writes (the batch's output, the volume, the census of
    rank 0's data and model groups)."""
    from afcm_tpu_torch.config import default_argument_parser
    from afcm_tpu_torch.evaluate import ModelAxisServer, make_forward_fn
    cfg = default_argument_parser(list(argv))
    server = ModelAxisServer(cfg, "cpu")
    if not server.lead:
        return server.serve()
    try:
        out = server.forward(*(torch.from_numpy(v) for v in batch))
        res = int(cfg.model.G.img_resolution)
        volume = stitched(make_forward_fn(server.model, "cpu", seed=3, server=server),
                          os.path.join(out_dir, "served"),
                          stub_loader(depth, res, int(cfg.model.G.img_channels_in)))
    finally:
        server.close()
    torch.save((out, volume, _census(server.group, server.model_group)),
               os.path.join(out_dir, "r0_serve.pt"))


def tp_int8_forward(rank, world, model_path, inputs, out_dir):
    """G_ema's eval forward over a (1, world) mesh with every eligible conv
    routed to the int8 conv (``int8_all``, floor 32 channels; its plain
    version on the CPU); writes (output, routed convs counted)."""
    from afcm_tpu_torch.models.gan_model import eval_forward
    from afcm_tpu_torch.ops import modulated_conv
    model = torch.load(model_path, weights_only=False)
    _, model_group = parallel.make_groups(world)
    parallel.shard_module(model.generator_ema, model_group)
    routed = []
    real = modulated_conv.conv3x3_int8_ste
    modulated_conv.conv3x3_int8_ste = lambda x, w, p: routed.append(w.shape) or real(x, w, p)
    modulated_conv.set_conv_impl("int8_all", min_ch=32)
    with torch.no_grad():
        out = eval_forward(model.generator_ema, model.c_dim,
                           *(torch.from_numpy(v) for v in inputs))
    torch.save((out, routed), os.path.join(out_dir, f"r{rank}_int8.pt"))


def tp_step_check(rank, world, argv, batch, out_dir):
    """``parallel.check.train_step_check`` over a (1, world) mesh."""
    from afcm_tpu_torch.config import default_argument_parser
    from afcm_tpu_torch.parallel.check import train_step_check
    group, model_group = parallel.make_groups(world)
    result = train_step_check(default_argument_parser(list(argv)), batch, "cpu", seed=3,
                              draw_seed=4, group=group, model_group=model_group)
    torch.save(result, os.path.join(out_dir, f"r{rank}_check.pt"))


def _torch_args(values):
    return [torch.from_numpy(v) if isinstance(v, np.ndarray) else v for v in values]


def tp_forwards(rank, world, cases, out_dir):
    """Over a (1, world) mesh, for each (name, module path, args, kwargs,
    grads, conv impl) of ``cases``: the pickled module sharded
    (``shard_module``) and its forward on ``args`` and ``kwargs`` (numpy
    arrays become tensors) under that conv implementation, the int8 conv's
    calls counted (the weight slice's shape); with ``grads``, every
    parameter's whole gradient of the output's sum, the replicated ones
    reduced as the train step reduces them (``reduce_replicated_``) and the
    sharded ones gathered. Writes {name: (output, grads, int8 calls,
    census)} as ``r{rank}_forwards.pt``."""
    from afcm_tpu_torch.ops import modulated_conv
    _, model_group = parallel.make_groups(world)
    results = {}
    real = modulated_conv.conv3x3_int8_ste
    for name, path, args, kwargs, grads, impl in cases:
        module = torch.load(path, weights_only=False)
        parallel.shard_module(module, model_group)
        routed = []
        modulated_conv.conv3x3_int8_ste = lambda x, w, p: routed.append(tuple(w.shape)) or \
            real(x, w, p)
        modulated_conv.set_conv_impl(impl)
        try:
            with torch.set_grad_enabled(grads):
                out = module(*_torch_args(args), **dict(zip(kwargs, _torch_args(
                    kwargs.values()))))
        finally:
            modulated_conv.conv3x3_int8_ste = real
            modulated_conv.set_conv_impl("xla")
        whole = {}
        if grads:
            params = list(module.parameters())
            got = list(torch.autograd.grad(out.sum(), params, allow_unused=True))
            got = [torch.zeros_like(p) if g is None else g for p, g in zip(params, got)]
            model_group.reduce_replicated_(module, params, got)
            sharded = {id(m.weight) for m in parallel.tensor.sharded_layers(module)}
            whole = {k: model_group.gather_dim0(g) if id(p) in sharded else g
                     for (k, p), g in zip(module.named_parameters(), got)}
        results[name] = (out.detach(), whole, routed, model_group.take_census())
    torch.save(results, os.path.join(out_dir, f"r{rank}_forwards.pt"))
