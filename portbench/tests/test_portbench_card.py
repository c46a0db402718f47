"""On the card, at each cell's own size: the control (the program's own
int8 conv path, ``tpu.conv_int8 True``) and, for the training cells, a
step on half of the batch come out not correct on three seeds each, the
seeds the cells' limits were read on where there are such. Minutes a
cell: ``python -m pytest portbench/tests/test_portbench_card.py`` on the
card."""

import json
import time

import pytest

from afcm_tpu_torch.models.gan_model import GANModel
from portbench import run as bench
from portbench.harness import spec

SEEDS = (3900000001, 3900000002, 3900000003)
# the seeds each cell's control and half-batch fault were read on
CONTROL_SEEDS = {"cmsr-serve": (3100000001, 3100000002, 3100000003),
                 "cmsr-train": (3200000001, 3200000002, 3200000003),
                 "ccsr-serve": (3300000101, 3300000102, 3900000003),
                 "ccsr-train": (3300000001, 3300000002, 3300000003)}
HALF_SEEDS = {"cmsr-train": (3200000004, 3200000005, 3900000003),
              "ccsr-train": (3300000004, 3300000005, 3900000003)}


def cells(kind):
    bench_json = json.load(open(spec.ROOT + "/BENCHMARK.json"))
    return [w["name"] for w in bench_json["workloads"]
            if spec.find_cell(w["name"]).traffic["kind"] == kind]


def run(cell_name, seed, device, overrides=None):
    readings = {}
    line = bench.run_cell(spec.find_cell(cell_name), seed, 3.0, False, device,
                          started=time.perf_counter(), overrides=overrides,
                          readings_out=readings)
    return line, readings


def with_seeds(names, seeds):
    return [(name, seed) for name in names for seed in seeds.get(name, SEEDS)]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,seed", with_seeds(cells("serve") + cells("train"), CONTROL_SEEDS))
def test_control_is_not_correct_at_cell_size(card, cell, seed):
    line, readings = run(cell, seed, card, {"tpu.conv_int8": True})
    assert line["correct"] is False, readings


@pytest.mark.cuda
@pytest.mark.parametrize("cell,seed", with_seeds(cells("train"), HALF_SEEDS))
def test_half_batch_step_is_not_correct_at_cell_size(card, cell, seed, monkeypatch):
    step = GANModel.train_step

    def half(self, batch, cur_nimg, **kwargs):
        n = batch["A"].shape[0] // 2
        return step(self, {k: v[:n] for k, v in batch.items()}, cur_nimg, **kwargs)
    monkeypatch.setattr(GANModel, "train_step", half)
    line, readings = run(cell, seed, card)
    assert line["correct"] is False, readings
