"""The port's tensor parallelism (afcm_tpu_torch.parallel.tensor) against
afcm_tpu on the CPU.

``afcm_tpu`` shards its state over the mesh's model axis by shape
(``shard_params``, ``infer_param_sharding``) and GSPMD inserts the gathers,
so its sharded step is its single-device step (tests/test_parallel.py:
41-82). The port runs D·M gloo ranks, rank r at data index r // M and
model index r % M, each data row with its contiguous slice of the global
batch and each model rank with its slice of the sharded parameters. Here:
the rule against ``afcm_tpu``'s, also on every parameter of the shipped
CMSR G and D; a (2, 2) train step with R1 against ``afcm_tpu``'s step on
its virtual (2, 2) mesh, at ``_compare_step``'s bounds, from one state
carried across by ``load_jax_train_state`` with the same numpy inputs and
z (tests/test_torch_parallel.py's precedent); the collective census of a
(4, 1) and a (2, 2) step; the sharded eval step and the stitched predictor
volume over (2, 2) against one process and ``afcm_tpu`` (rtol 2e-4, atol
2e-5, tests/test_parallel.py:162-243); a checkpoint written at (1, 2) that
loads bit-equal into one process and resumes; the int8 routing decided on
the whole conv; and the train CLI starting D·M ranks. The ranks are in
tests/_torch_ranks.py (no JAX in the children), one thread each, with a
300 s bound on their collectives and on the join.
"""

import copy
import functools
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from afcm_tpu import models as jmodels  # noqa: E402
from afcm_tpu.parallel import infer_param_sharding as jax_rule  # noqa: E402
from afcm_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from afcm_tpu.parallel import shard_batch as jax_shard_batch  # noqa: E402
from afcm_tpu.parallel import shard_params as jax_shard_params  # noqa: E402
from afcm_tpu_torch import parallel  # noqa: E402
from afcm_tpu_torch.models import (GANConfig, GANModel, build_discriminator,  # noqa: E402
                                   build_generator)
from afcm_tpu_torch.parallel.tensor import SHARD, infer_param_sharding  # noqa: E402
from afcm_tpu_torch.utils.port import load_jax_train_state  # noqa: E402
from tests import _torch_ranks as ranks  # noqa: E402
from tests.test_torch_train import TINY_D, TINY_G  # noqa: E402
from tests.test_torch_train import _compare_step as compare_gan_step  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs/demo/cmsr_tiny.yml")
CMSR = os.path.join(REPO, "configs/adni/stylegan3/cmsr.yml")
TIMEOUT_S = 300
STEP_CFG = dict(z_dim=32, c_dim=1, batch_size=4, blur_init_sigma=2.0, blur_fade_kimg=1.0)


def _spawn(tmp_path, world, fn, *args):
    parallel.spawn(fn, world, args, backend="gloo", init_file=str(tmp_path / "store"),
                   device_type="cpu", threads=1, timeout_s=TIMEOUT_S)


def _load(path):
    return torch.load(path, weights_only=False)


def _batch(seed, n=4, size=32):
    rng = np.random.RandomState(seed)
    return {"A": rng.randn(n, 4, size, size).clip(-1, 1).astype(np.float32),
            "B": rng.randn(n, 1, size, size).clip(-1, 1).astype(np.float32),
            "slice_idx": rng.rand(n, 1).astype(np.float32)}


def _whole_model(model_path, nets, optim):
    """The pickled model with the whole states a rank wrote loaded into it."""
    model = _load(model_path)
    for name, state in nets.items():
        getattr(model, name).load_state_dict(state, strict=True)
    for key, state in optim.items():
        getattr(model, key).load_state_dict(state)
    return model


def _assert_equal_states(a, b):
    for net in a:
        for k in a[net]:
            assert torch.equal(a[net][k], b[net][k]), f"{net} {k}"


# -- the placement rule -----------------------------------------------------------

@pytest.mark.parametrize("shape", [(512, 256), (511, 256), (512,), (16, 8, 3, 3),
                                   (8, 8, 3, 3), (32, 1), (1, 64, 1, 1), (362, 512, 3, 3),
                                   (181, 1536), (64, 4, 3, 3)])
def test_rule_matches_afcm_tpu(shape):
    """tests/test_parallel.py:29-38 and more shapes: the port's copy of
    the rule shards exactly where ``afcm_tpu``'s places ``P("model")``, on
    model axes of 1, 2, 4 and 8."""
    for model in (1, 2, 4, 8):
        want = jax_rule("w", shape, jax_make_mesh((8 // model, model))).spec == P("model")
        assert (infer_param_sharding("w", shape, model) == SHARD) == want, (shape, model)


@pytest.fixture(scope="module")
def shipped_gan():
    from afcm_tpu_torch.config import default_argument_parser
    from afcm_tpu_torch.models import build_gan_model
    return build_gan_model(default_argument_parser(["--config-file", CMSR]),
                           generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("model,g_counts,d_counts", [
    (2, (48, 57_275_584), (31, 26_355_008)),
    (4, (45, 54_217_408), (31, 26_355_008)),
])
def test_rule_on_the_shipped_cmsr_gan(shipped_gan, model, g_counts, d_counts):
    """Every parameter of the shipped CMSR G (58,497,071 elements, 55
    tensors of at least 2 dims holding 58,476,224) and D (26,365,632
    elements, 31 such tensors holding 26,355,008, all of which shard) is
    placed as ``afcm_tpu`` places it; the tensors and elements that shard at
    M = 2 and 4. G's replicated ones at M = 2 are the seven of 91, 181 and
    1 output channels; M = 4 adds the three of 362."""
    mesh = jax_make_mesh((8 // model, model))
    for net, want in ((shipped_gan.generator, g_counts),
                      (shipped_gan.discriminator, d_counts)):
        shard = [(n, p.numel()) for n, p in net.named_parameters()
                 if infer_param_sharding(n, p.shape, model) == SHARD]
        for n, p in net.named_parameters():
            assert (infer_param_sharding(n, p.shape, model) == SHARD) == (
                jax_rule(n, tuple(p.shape), mesh).spec == P("model")), n
        assert (len(shard), sum(k for _, k in shard)) == want
    for net, whole, matrices in ((shipped_gan.generator, 58_497_071, (55, 58_476_224)),
                                 (shipped_gan.discriminator, 26_365_632, (31, 26_355_008))):
        assert sum(p.numel() for p in net.parameters()) == whole
        kept = [p for p in net.parameters() if p.ndim >= 2]
        assert (len(kept), sum(p.numel() for p in kept)) == matrices
    if model == 2:
        kept = {n for n, p in shipped_gan.generator.named_parameters()
                if p.ndim >= 2 and infer_param_sharding(n, p.shape, 2) != SHARD}
        assert kept == {"synthesis.encoder_2.weight", "synthesis.encoder_4.weight",
                        "synthesis.L9_148_181.weight", "synthesis.L10_276_128.affine.weight",
                        "synthesis.L11_276_91.weight", "synthesis.L12_276_64.affine.weight",
                        "synthesis.L14_256_1.weight"}


# -- training ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gan_case(tmp_path_factory):
    """afcm_tpu's initial state of the tiny GAN, the port's model carried
    from it (pickled for the ranks), and two steps' inputs (R1 on both)."""
    jmodel = jmodels.GANModel(jmodels.build_generator(dict(TINY_G)),
                              jmodels.build_discriminator(dict(TINY_D)),
                              jmodels.GANConfig(**STEP_CFG))
    state = jax.tree.map(np.asarray, jmodel.init_state(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in _batch(0).items()}))
    net_g = build_generator(dict(TINY_G))
    port = GANModel(GANConfig(**STEP_CFG), copy.deepcopy(net_g), net_g,
                    build_discriminator(dict(TINY_D)))
    load_jax_train_state(port, state)
    path = tmp_path_factory.mktemp("gan") / "model.pt"
    torch.save(port, path)
    steps = [(_batch(100 + i), np.random.RandomState(120 + i).randn(4, 32).astype(np.float32),
              4.0 * i, True) for i in (1, 2)]
    return jmodel, state, str(path), steps


@pytest.fixture(scope="module")
def tp_run(gan_case, tmp_path_factory):
    """Four ranks: the two steps over a (2, 2) mesh, then the first over a
    (4, 1) mesh. The (2, 2) ranks' outputs per step, and the (4, 1)
    census."""
    _, _, path, steps = gan_case
    out = tmp_path_factory.mktemp("tp22")
    _spawn(out, 4, ranks.tp_steps, path, [(2, steps), (1, steps[:1])], str(out))
    return ([[_load(out / f"r{r}_m2_s{s}.pt") for r in range(4)] for s in (1, 2)],
            _load(out / "r0_m1_s1.pt")[3])


def test_train_step_on_a_2x2_mesh_matches_jax(gan_case, tp_run):
    """Two steps with R1 over a (2, 2) mesh against afcm_tpu's
    ``_train_step_impl`` on its (2, 2) mesh (``shard_params`` on the state,
    ``shard_batch`` on the inputs), z injected: each rank's losses, and its
    whole G, D, G_ema and Adam moments (``full_state_dict``), at
    ``_compare_step``'s bounds; all four ranks end with the same whole
    state."""
    jmodel, state, path, steps = gan_case
    mesh = jax_make_mesh((2, 2))
    state = jax_shard_params(jax.tree.map(jnp.asarray, state), mesh)
    key = jax.random.PRNGKey(5)           # dropout is 0: the key is unused
    checked = {}
    run = jax.jit(functools.partial(jmodel._train_step_impl, with_r1=True))
    for step, (batch, z, nimg, with_r1) in enumerate(steps, start=1):
        assert with_r1
        state, jax_metrics = run(state, jax_shard_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}, mesh),
            jnp.asarray(z), key, key, jnp.asarray(nimg))
        want = jax.tree.map(np.asarray, state)
        results = tp_run[0][step - 1]
        for rank, (metrics, nets, optim, _) in enumerate(results):
            compare_gan_step(_whole_model(path, nets, optim), want, metrics, jax_metrics,
                             f"(2, 2) rank {rank} step {step}", checked)
            _assert_equal_states(nets, results[0][1])


def test_census_of_a_4x1_and_a_2x2_step(tp_run):
    """tests/test_parallel.py:133-160's counterpart: a (4, 1) step has no
    tensor-parallel collective, a (2, 2) step adds the channel gathers, the
    styles' gathers, the input gradients' sums and one partial-gradient sum
    per net; both all-reduce each net's gradient once over the data axis."""
    steps, dp = tp_run
    tp = steps[0][0][3]
    assert not [k for k in dp if k.startswith("tp_")], dp
    assert tp["tp_gather"]["count"] > 0 and tp["tp_styles"]["count"] > 0
    assert tp["tp_enter"]["count"] > 0 and tp["tp_partial_grads"]["count"] == 2
    for census in (dp, tp):
        assert census["grads"]["count"] == 2 and census["metrics"]["count"] == 1
    assert all(r[3] == tp for r in steps[0])


def test_checkpoint_at_1x2_loads_into_one_process(gan_case, tmp_path):
    """``save_state`` over a (1, 2) mesh writes the whole tensors in the
    one-process layout: the files load strictly into one process, bit-equal
    to the ranks' whole state, Adam's moments too; ``load_state`` back over
    (1, 2) resumes: the next step from the loaded state equals the
    uninterrupted one bit for bit."""
    from afcm_tpu_torch.utils import checkpoint as ckpt
    _, _, path, steps = gan_case
    _spawn(tmp_path, 2, ranks.tp_checkpoint, path, steps, str(tmp_path))
    one = _load(path)
    ckpt.load_state(one, str(tmp_path / "ckpt"), "mid")
    for rank in range(2):
        result = _load(tmp_path / f"r{rank}_ckpt.pt")
        nets, optim = result["saved"]
        _assert_equal_states(nets, {n: getattr(one, n).state_dict() for n in nets})
        for key in optim:
            got = getattr(one, key).state_dict()["state"]
            for i, entry in optim[key]["state"].items():
                assert all(torch.equal(entry[k], got[i][k]) for k in entry), (key, i)
        first, loaded = result["metrics"]
        assert {k: float(v) for k, v in first.items()} == \
            {k: float(v) for k, v in loaded.items()}
        _assert_equal_states(*(nets for nets, _ in result["after"]))


@pytest.mark.parametrize("remat", [False, True])
def test_step_check_over_a_1x2_mesh_against_one_process(tmp_path, remat):
    """The step check ``chip_smoke.py`` (phase 20) and
    ``scripts/torch_tensor_parallel.py`` run, at the tiny config's global
    batch of 4 over a (1, 2) mesh: the losses within rtol 1e-5 and each
    net's whole gradient within 1e-5 in relative L2 of one process's, both
    ranks holding the same whole gradients; the census counts the model
    axis's collectives. Under remat each checkpointed layer gathers again
    in the backward's recompute."""
    from afcm_tpu_torch.config import default_argument_parser
    from afcm_tpu_torch.parallel.check import grad_errors, train_step_check
    argv = ["--config-file", CONFIG, "loaders.batch_size", "4", "tpu.remat", str(remat)]
    rng = np.random.RandomState(9)
    batch = {"A": rng.uniform(-1, 1, (4, 4, 64, 64)).astype(np.float32),
             "B": rng.uniform(-1, 1, (4, 1, 64, 64)).astype(np.float32),
             "slice_idx": rng.rand(4, 1).astype(np.float32)}
    _spawn(tmp_path, 2, ranks.tp_step_check, argv, batch, str(tmp_path))
    want = train_step_check(default_argument_parser(argv), batch, "cpu", seed=3, draw_seed=4)
    got = [_load(tmp_path / f"r{r}_check.pt") for r in range(2)]
    for k, v in want["metrics"].items():
        assert got[0]["metrics"][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    assert got[0]["grads"].keys() == want["grads"].keys()
    err = grad_errors(got[0]["grads"], want["grads"])
    assert set(err) == {"G", "D"} and max(err.values()) < 1e-5, err
    assert all(torch.equal(got[1]["grads"][k], g) for k, g in got[0]["grads"].items())
    census = got[0]["census"]
    assert census["tp_gather"]["count"] > 0 and census["tp_partial_grads"]["count"] == 2
    assert census["grads"]["count"] == 2


# -- serving ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The tiny demo config's G_ema, initialized by afcm_tpu, carried across
    and saved as a run's latest_net_G_ema.pth; the JAX state too."""
    from afcm_tpu.config import setup
    from afcm_tpu.models import build_gan_model
    from afcm_tpu_torch.config import default_argument_parser
    from afcm_tpu_torch.models import build_eval_model
    from afcm_tpu_torch.utils.port import load_jax_variables

    class Args:
        config_file, model, opts = CONFIG, None, []
    jmodel = build_gan_model(setup(Args()))
    dummy = {"A": jnp.zeros((1, 4, 64, 64)), "B": jnp.zeros((1, 1, 64, 64)),
             "slice_idx": jnp.zeros((1, 1))}
    state = jax.tree.map(np.asarray, jmodel.init_state(jax.random.PRNGKey(0), dummy))
    checkpoints = tmp_path_factory.mktemp("run")
    argv = ["--config-file", CONFIG, "checkpoints_dir", str(checkpoints),
            "loaders.batch_size", "4"]
    model = build_eval_model(dict(default_argument_parser(argv).model.G))
    load_jax_variables(model.generator_ema, {"params": state.params_G_ema,
                                             "moments": state.moments_G_ema,
                                             "constants": state.constants_G})
    (checkpoints / "demo_tiny").mkdir()
    torch.save(model.generator_ema.state_dict(),
               checkpoints / "demo_tiny" / "latest_net_G_ema.pth")
    return jmodel, state, model, argv


def test_eval_step_and_stitched_volume_over_2x2_match(tiny_run, tmp_path):
    """``evaluate.ModelAxisServer`` over a (2, 2) mesh: one batch's eval
    step, and the volume ``StandardPredictor`` stitches of ten 64² slices
    (z per batch from seed 3), against one process's and against
    afcm_tpu's over its (2, 2) mesh fed the same z (``shard_params`` state,
    batch sharded over the data axis), at tests/test_parallel.py:162-243's
    rtol 2e-4, atol 2e-5. The server's exchanges are counted."""
    from afcm_tpu_torch.evaluate import make_forward_fn
    from afcm_tpu_torch.models.gan_model import eval_forward
    jmodel, state, model, argv = tiny_run
    rng = np.random.RandomState(4)
    batch = (rng.randn(4, 4, 64, 64).clip(-1, 1).astype(np.float32),
             rng.rand(4, 1).astype(np.float32), rng.randn(4, 64).astype(np.float32))
    _spawn(tmp_path, 4, ranks.tp_serve, argv + ["tpu.mesh_shape", "[2, 2]"], batch, 10,
           str(tmp_path))
    out, volume, census = _load(tmp_path / "r0_serve.pt")
    with torch.no_grad():
        want = eval_forward(model.generator_ema, 1, *(torch.from_numpy(v) for v in batch))
    torch.testing.assert_close(out, want, rtol=2e-4, atol=2e-5)
    loader = ranks.stub_loader(10, 64)
    one = ranks.stitched(make_forward_fn(model, "cpu", seed=3), tmp_path / "one", loader)
    assert volume.shape == (10, 64, 64) and np.isfinite(volume).all()
    np.testing.assert_allclose(volume, one, rtol=2e-4, atol=2e-5)
    assert census["serve_batch"]["count"] == census["serve_result"]["count"] == 4
    assert census["tp_gather"]["count"] > 0

    mesh = jax_make_mesh((2, 2))
    variables = jax_shard_params({"params": state.params_G_ema,
                                  "moments": state.moments_G_ema,
                                  "constants": state.constants_G}, mesh)
    sharding = NamedSharding(mesh, P("data"))
    apply = jax.jit(lambda z, c, a: jmodel.generator.apply(
        variables, z, c, a, train=False, noise_mode="const"))
    np.testing.assert_allclose(out.numpy(), np.asarray(apply(*(
        jax.device_put(jnp.asarray(v), sharding) for v in (batch[2], batch[1], batch[0])))),
        rtol=2e-4, atol=2e-5)
    draws = torch.Generator().manual_seed(3)

    def jax_forward(a_batch, slice_idx):
        z = torch.randn((a_batch.shape[0], 64), generator=draws).numpy()
        return apply(*(jax.device_put(jnp.asarray(x), sharding)
                       for x in (z, slice_idx, a_batch)))

    jax_volume = ranks.stitched(jax_forward, tmp_path / "jax", ranks.stub_loader(10, 64))
    np.testing.assert_allclose(volume, jax_volume, rtol=2e-4, atol=2e-5)


def test_int8_routing_on_slices_is_the_whole_convs(gan_case, tmp_path):
    """Under ``int8_all`` (floor 32 channels) the routing decides on the
    whole conv: over a (1, 4) mesh each 32-channel conv's slice of 8 output
    channels is routed as the whole conv is in one process (``_int8_gate``
    and the floor see the global O), and, the quantization being per output
    channel, the sharded G_ema's output is one process's. The plain int8
    conv on the CPU: bit for bit per conv, 1e-5 of the output's range for
    the generator (float32 rounding of the float ops around the routed
    convs in another order moves single quantization steps)."""
    from afcm_tpu_torch.models.gan_model import eval_forward
    from afcm_tpu_torch.ops import modulated_conv
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(2, 32, 12, 12).astype(np.float32))
    w = torch.from_numpy(rng.randn(32, 32, 3, 3).astype(np.float32))
    _, _, path, steps = gan_case
    batch, z, _, _ = steps[0]
    inputs = (batch["A"], batch["slice_idx"], z)
    model = _load(path)
    routed = []
    real = modulated_conv.conv3x3_int8_ste
    modulated_conv.conv3x3_int8_ste = lambda x, w, p: routed.append(w.shape) or real(x, w, p)
    modulated_conv.set_conv_impl("int8_all", min_ch=32)
    try:
        whole = modulated_conv.conv2d(x, w, padding=1)
        parts = [modulated_conv.conv2d(x, w[i * 8:(i + 1) * 8], padding=1, out_channels=32)
                 for i in range(4)]
        assert len(routed) == 5
        modulated_conv.conv2d(x, w[:8], padding=1)
        assert len(routed) == 5                 # a slice alone is under the floor
        routed.clear()
        with torch.no_grad():
            want = eval_forward(model.generator_ema, 1, *(torch.from_numpy(v) for v in inputs))
    finally:
        modulated_conv.conv3x3_int8_ste = real
        modulated_conv.set_conv_impl("xla", min_ch=64)
    assert torch.equal(torch.cat(parts, 1), whole)
    assert routed
    _spawn(tmp_path, 4, ranks.tp_int8_forward, path, inputs, str(tmp_path))
    for rank in range(4):
        out, got = _load(tmp_path / f"r{rank}_int8.pt")
        assert [(o // 4 if o >= 32 else o, *rest) for o, *rest in routed] == \
            [tuple(s) for s in got]
        torch.testing.assert_close(out, want, rtol=0, atol=1e-5 * float(want.abs().max()))


# -- the CLIs ----------------------------------------------------------------------------

def test_train_cli_starts_a_rank_per_device_of_the_mesh(tmp_path, monkeypatch):
    """``python -m afcm_tpu_torch.train --device cpu tpu.mesh_shape [1, 2]``
    starts two gloo ranks from ``main()`` (tests/test_torch_parallel.py:
    381's counterpart): rank 0 alone writes the run's loss log and the
    checkpoints, whose G_ema loads strictly into one process (the serving
    CLIs over a mesh: tests/test_torch_serving.py)."""
    pytest.importorskip("h5py")
    from afcm_tpu_torch import evaluate
    from afcm_tpu_torch import train as train_cli
    from afcm_tpu_torch.config import default_argument_parser
    from afcm_tpu_torch.data.demo import write_demo_tree
    from afcm_tpu_torch.models import build_eval_model
    write_demo_tree(str(tmp_path / "data"), n_train=1, n_val=1, n_test=1, depth=8, size=64)
    worlds = []
    real = parallel.spawn

    def spawn(fn, world, args, **kw):
        worlds.append(world)
        return real(fn, world, args, **dict(kw, threads=1, timeout_s=TIMEOUT_S))

    monkeypatch.setattr(parallel, "spawn", spawn)
    argv = ["--config-file", CONFIG, "--device", "cpu",
            "loaders.train.file_paths", f"['{tmp_path}/data/train']",
            "loaders.val.file_paths", f"['{tmp_path}/data/val']",
            "loaders.test.file_paths", f"['{tmp_path}/data/test']",
            "checkpoints_dir", str(tmp_path / "checkpoints")]
    assert train_cli.main(argv + ["trainer.max_iters", "4", "tpu.mesh_shape", "[1, 2]"]) == {}
    run_dir = tmp_path / "checkpoints" / "demo_tiny"
    for name in ("net_G", "net_D", "net_G_ema", "optim"):
        assert (run_dir / f"latest_{name}.pth").exists(), name
    assert torch.load(run_dir / "latest_optim.pth", weights_only=True)["step"] == 2
    assert (run_dir / "loss_log.txt").read_text().count("Training Loss") == 1
    model = build_eval_model(dict(default_argument_parser(argv[:2]).model.G))
    evaluate.load_generator_ema(model, str(run_dir), "latest")
    assert worlds == [2]
