"""The traffic generators and the reference's data layer."""

import numpy as np
import pytest
import torch

from portbench.harness.check import serve_sample
from portbench.harness.phantoms import draw_pool, sub_seed
from portbench.reference.volumes import subject_windows, train_batches

SMALL = {"pool": 3, "depth_min": 6, "depth_max": 11, "size": 32,
         "modality_in": "flair", "modality_out": "t1_hr4sr"}


def test_pool_is_the_same_for_the_same_seed_and_differs_for_another():
    a = draw_pool(SMALL, 2 ** 31 + 7, "cpu")
    b = draw_pool(SMALL, 2 ** 31 + 7, "cpu")
    c = draw_pool(SMALL, 2 ** 31 + 8, "cpu")
    for va, vb in zip(a, b):
        for key in ("flair", "t1_hr4sr"):
            assert va[key].dtype == np.uint8
            np.testing.assert_array_equal(va[key], vb[key])
    assert any(va["flair"].shape != vc["flair"].shape or
               not np.array_equal(va["flair"], vc["flair"]) for va, vc in zip(a, c))
    assert all(6 <= v["flair"].shape[0] <= 11 for v in a)
    assert all(v["flair"].any() for v in a)         # anatomy inside the ellipsoid


@pytest.mark.parametrize("seed", [0, 2 ** 31 - 1, 2 ** 31 + 5, 2 ** 40 + 3])
def test_sub_seeds_take_any_seed_and_fit_31_bits(seed):
    seeds = {sub_seed(seed, k) for k in range(1, 10)}
    assert len(seeds) == 9 and all(0 <= s < 2 ** 31 for s in seeds)
    assert sub_seed(seed, 1) == sub_seed(seed, 1)


def test_serve_sample_holds_the_longest_subjects_edges_and_repeats():
    subjects = [{"depth": d} for d in (10, 14, 12)]
    a = serve_sample(subjects, 9, seed=5)
    assert a == serve_sample(subjects, 9, seed=5)
    assert len(a) == 9 and {(1, 0), (1, 1), (1, 12), (1, 13)} <= set(a)
    assert all(0 <= k < subjects[i]["depth"] for i, k in a)


def test_reference_windows_equal_the_ports_dataset():
    from afcm_tpu_torch.data.demo import PhantomSubject
    ds = PhantomSubject(depth=13, size=64, seed=3, phase="test")
    raw = ds.raw["flair"]
    windows, positions = subject_windows(raw, thickness=5)
    for i in range(raw.shape[0]):
        a, s, _ = ds.get_item_raw(i)
        np.testing.assert_array_equal(windows[i], a)
        np.testing.assert_allclose(positions[i], s)


def test_reference_train_batches_equal_the_ports_loader():
    from afcm_tpu_torch.data.loader import TrainLoader
    from portbench.harness.train import Pool
    from afcm_tpu_torch.data.demo import PhantomSubject
    subjects = [PhantomSubject(depth=d, size=64, seed=d, phase="train") for d in (9, 12)]
    loader = TrainLoader(Pool(subjects), batch_size=4, seed=11, prefetch=0)
    got = [b for _, b in zip(range(3), loader)]
    vols = [{"flair": s.raw["flair"], "t1_hr4sr": s.raw["t1_hr4sr"]} for s in subjects]
    want = train_batches(vols, "flair", "t1_hr4sr", 5, 4, 11, 3)
    for g, w in zip(got, want):
        for key in ("A", "B", "slice_idx"):
            np.testing.assert_allclose(g[key], w[key], atol=1e-6)
