"""The port's copies of the small host modules against the JAX package's,
on CPU: ``utils/misc.py``, ``utils/training_stats.py``, ``config/compat.py``
and ``data/prepare_h5.py`` (the counterparts of tests/test_misc_utils.py,
tests/test_aux.py, tests/test_misc_components.py and
tests/test_prepare_h5.py). Where both compute on the same numpy input the
result is held equal, exactly where both are numpy (the sampler's stream,
the h5 bytes) and at float32 rounding where one sums on torch (1e-6
relative). The cross-rank paths run on two gloo ranks
(``parallel.spawn``, as tests/test_torch_parallel.py starts them).
"""

import copy
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from afcm_tpu.config import CfgNode as JaxCfgNode  # noqa: E402
from afcm_tpu.config import compat as jcompat  # noqa: E402
from afcm_tpu.data import prepare_h5 as jprep  # noqa: E402
from afcm_tpu.models import build_generator as jax_build_generator  # noqa: E402
from afcm_tpu.utils import misc as jmisc  # noqa: E402
from afcm_tpu.utils import training_stats as jstats  # noqa: E402
from afcm_tpu_torch import parallel  # noqa: E402
from afcm_tpu_torch.config import CfgNode  # noqa: E402
from afcm_tpu_torch.config import compat  # noqa: E402
from afcm_tpu_torch.data import prepare_h5  # noqa: E402
from afcm_tpu_torch.models import build_generator  # noqa: E402
from afcm_tpu_torch.utils import misc, training_stats  # noqa: E402
from afcm_tpu_torch.utils.nifti import write_nifti  # noqa: E402
from afcm_tpu_torch.utils.port import variables_to_state_dict  # noqa: E402
from tests import _torch_ranks as ranks  # noqa: E402
from tests.test_torch_train import TINY_G  # noqa: E402

torch.set_num_threads(1)


def test_assert_shape_and_nan_to_num_match_jax():
    x = np.zeros((2, 3, 4), np.float32)
    for ref in ((2, None, 4), (2, 3, 5), (2, 3), (None, None, None)):
        outcomes = []
        for fn, t in ((jmisc.assert_shape, jnp.asarray(x)), (misc.assert_shape, torch.from_numpy(x))):
            try:
                fn(t, ref)
                outcomes.append(None)
            except AssertionError as exc:
                outcomes.append(str(exc))
        assert outcomes[0] == outcomes[1], ref
    v = np.array([np.nan, np.inf, -np.inf, 1.5], np.float32)
    for kwargs in ({}, dict(nan=2.0, posinf=7.0, neginf=-7.0)):
        np.testing.assert_array_equal(misc.nan_to_num(torch.from_numpy(v), **kwargs).numpy(),
                                      np.asarray(jmisc.nan_to_num(jnp.asarray(v), **kwargs)))


def test_module_summary_names_and_counts_match_jax():
    """The tiny G: the port's parameters and buffers by state_dict name are
    the JAX variables' paths, so the two summaries list the same tensors
    and total; num_params of the module is that of JAX's params, and of a
    state_dict that of every tensor in it."""
    z = np.zeros((1, 32), np.float32)
    jgen = jax_build_generator(dict(TINY_G))
    variables = jax.tree.map(np.asarray, jgen.init(
        jax.random.PRNGKey(0), z, np.zeros((1, 1), np.float32),
        np.zeros((1, 4, 32, 32), np.float32)))
    net = build_generator(dict(TINY_G))
    assert misc.num_params(net) == jmisc.num_params(variables["params"])
    want = variables_to_state_dict(variables)
    assert misc.num_params(net.state_dict()) == sum(v.size for v in want.values())
    text = misc.print_module_summary(net)
    rows = {line.split()[0] for line in text.splitlines()[1:-1]}
    assert rows == set(want)
    jtext = jmisc.print_module_summary(variables)
    assert text.splitlines()[-1] == jtext.splitlines()[-1]
    sd_text = misc.print_module_summary(net.state_dict(), max_rows=3)
    assert sd_text.splitlines()[-1] == jtext.splitlines()[-1]
    assert f"({len(want) - 3} more)" in sd_text


@pytest.mark.parametrize("size,rank,replicas,shuffle,seed,window", [
    (10, 0, 2, False, 0, 0.5), (10, 1, 2, False, 0, 0.5), (8, 0, 1, True, 3, 0.5),
    (13, 2, 3, True, 5, 0.25), (7, 0, 1, True, 1, 0.0)])
def test_infinite_sampler_stream_equals_jax(size, rank, replicas, shuffle, seed, window):
    kwargs = dict(rank=rank, num_replicas=replicas, shuffle=shuffle, seed=seed,
                  window_size=window)
    got, want = iter(misc.InfiniteSampler(size, **kwargs)), iter(jmisc.InfiniteSampler(size, **kwargs))
    assert [next(got) for _ in range(200)] == [next(want) for _ in range(200)]


def test_replica_consistency_over_replicate_state():
    """Over the module copies of ``parallel.replicate_state`` (a two-CPU
    mesh): equal copies pass, a moved parameter or buffer raises naming it."""
    net = build_generator(dict(TINY_G), generator=torch.Generator().manual_seed(0))
    mesh = parallel.make_mesh((2, 1), devices=[torch.device("cpu")] * 2)
    replicas = parallel.replicate_state(net, mesh)
    assert misc.check_replica_consistency(replicas)
    assert misc.check_replica_consistency(net)        # alone: nothing to compare
    moved = [replicas[0], copy.deepcopy(replicas[1])]
    with torch.no_grad():
        moved[1].mapping.w_avg += 1
    with pytest.raises(AssertionError, match="mapping.w_avg"):
        misc.check_replica_consistency(moved)


def test_report_moments_and_collector_match_jax():
    values = np.random.RandomState(0).randn(100).astype(np.float32)
    got = training_stats.report_moments(torch.from_numpy(values))
    want = np.asarray(jstats.report_moments(jnp.asarray(values)))
    assert got.dtype == torch.float32 and got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    port, jax_c = training_stats.Collector("lo.*"), jstats.Collector("lo.*")
    for c, triple in ((port, got), (jax_c, want)):
        c.update({"loss": triple, "other": triple})
        c.update({"loss": np.asarray(3.0)})
    assert port.names() == jax_c.names() == ["loss"]
    for k, v in jax_c.as_dict()["loss"].items():
        assert port.as_dict()["loss"][k] == pytest.approx(v, rel=1e-6)
    port.reset()
    assert port.names() == [] and np.isnan(port.mean("loss")) and port.std("loss") == 0.0


def test_moments_and_replica_check_across_two_gloo_ranks(tmp_path):
    """Two gloo ranks: each rank's triple of its half, summed through the
    group (one counted all-reduce), equals the JAX function's triple of the
    whole array; a module equal on both ranks passes the replica check and
    one whose bias moved on rank 1 fails it on both."""
    values = np.random.RandomState(1).randn(2, 50).astype(np.float32)
    parallel.spawn(ranks.host_utils, 2, (values, str(tmp_path)), backend="gloo",
                   init_file=str(tmp_path / "store"), device_type="cpu", threads=1,
                   timeout_s=300)
    want = np.asarray(jstats.report_moments(jnp.asarray(values)))
    for rank in range(2):
        triple, census, consistent, mismatch = torch.load(tmp_path / f"r{rank}_host.pt")
        np.testing.assert_allclose(triple.numpy(), want, rtol=1e-6)
        assert census == {"sum": {"count": 1, "bytes": 12}}
        assert consistent is True
        assert mismatch == "Replica mismatch at bias on rank 1"


def test_config_upgrade_matches_jax():
    for version in (1, 2):
        got = compat.upgrade_config(CfgNode({"VERSION": version, "name": "x"}), 2)
        want = jcompat.upgrade_config(JaxCfgNode({"VERSION": version, "name": "x"}), 2)
        assert isinstance(got, CfgNode) and dict(got) == dict(want)
        down = compat.downgrade_config(got, 1)
        assert dict(down) == dict(jcompat.downgrade_config(want, 1)) and got.VERSION == 2
    for fn in (compat.upgrade_config, jcompat.upgrade_config):
        with pytest.raises(AssertionError):
            fn(CfgNode({"VERSION": 3, "name": "x"}), 2)
    assert compat.LATEST_VERSION == jcompat.LATEST_VERSION


def test_prepare_h5_writes_the_same_bytes_as_jax(tmp_path):
    """One subject of two modalities (and one missing), converted by both
    packages: equal h5 datasets per modality, byte for byte; the CLI of the
    port writes the same file; rescale_intensity equals JAX's on every
    option of tests/test_prepare_h5.py."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.RandomState(0)
    subject = tmp_path / "nii" / "sub01"
    subject.mkdir(parents=True)
    for modality in ("T1_HR", "T2_FLAIR_linear"):
        vol = rng.gamma(2.0, 120.0, size=(6, 32, 32)).astype(np.float32)
        vol[vol < 30] = 0
        write_nifti(str(subject / f"sub01_{modality}.nii.gz"), vol)
    modalities = ["T1_HR", "T2_FLAIR_linear", "T2_absent"]
    outs = {}
    for name, module in (("port", prepare_h5), ("jax", jprep)):
        (tmp_path / name).mkdir()
        outs[name] = module.convert_subject("sub01", str(tmp_path / "nii"),
                                            str(tmp_path / name), modalities, 32)
    prepare_h5.main(["--data-path", str(tmp_path / "nii"), "--out-path",
                     str(tmp_path / "cli"), "--size", "32"])
    with h5py.File(outs["port"]) as a, h5py.File(outs["jax"]) as b, \
            h5py.File(tmp_path / "cli" / "sub01.h5") as c:
        assert sorted(a) == sorted(b) == sorted(c) == ["T1_HR", "T2_FLAIR_linear"]
        for key in a:
            assert a[key].dtype == b[key].dtype == np.uint8
            assert a[key][()].tobytes() == b[key][()].tobytes() == c[key][()].tobytes()
    with pytest.raises(AssertionError, match="expected 64"):
        prepare_h5.convert_subject("sub01", str(tmp_path / "nii"), str(tmp_path / "port"),
                                   modalities, 64)
    vol = rng.gamma(2.0, 120.0, size=(8, 32, 32)).astype(np.float32)
    vol[vol < 30] = 0
    for kwargs in (dict(), dict(bins_num=0), dict(norm=True),
                   dict(percentils=(2, 98), bins_num=128)):
        np.testing.assert_array_equal(prepare_h5.rescale_intensity(vol.copy(), **kwargs),
                                      jprep.rescale_intensity(vol.copy(), **kwargs))
    assert os.path.exists(outs["port"])
