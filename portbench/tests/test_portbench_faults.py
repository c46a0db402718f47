"""The check comes out false when the timed path is broken underneath, and
under the control, on a CPU-sized cell (``tiny.py``, float32): the rest of
a run is driven as on the card, without the harness's look for a card."""

import numpy as np
import pytest
import torch

import afcm_tpu_torch.evaluate as port_evaluate
import afcm_tpu_torch.models.gan_model as port_gan_model
import afcm_tpu_torch.models.losses as port_losses
import afcm_tpu_torch.ops.modulated_conv as port_conv
from afcm_tpu_torch.models.gan_model import GANModel
from portbench.tests.tiny import make_root, run_tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("tiny")))


def int8_everywhere(monkeypatch):
    """The control: the program's own int8 conv path on every conv the
    tiny model has (the shipped gate routes only >= 256-channel convs)."""
    monkeypatch.setattr(port_conv, "_int8_gate", lambda x_shape, w_shape: True)
    return {"tpu.conv_int8": True, "tpu.conv_int8_min_ch": 8}


@pytest.mark.parametrize("cell", ["tiny-serve", "tiny-train"])
def test_sound_runs_are_correct(root, cell):
    line, _ = run_tiny(root, cell)
    assert line["correct"] is True


@pytest.mark.parametrize("cell", ["tiny-serve", "tiny-train"])
def test_control_is_not_correct(root, cell, monkeypatch):
    line, readings = run_tiny(root, cell, overrides=int8_everywhere(monkeypatch))
    assert line["correct"] is False, readings


def test_serve_answer_altered_where_produced(root, monkeypatch):
    forward = port_evaluate.eval_forward

    def altered(*args, **kwargs):
        out = forward(*args, **kwargs).clone()
        out[0] += 0.05
        return out
    monkeypatch.setattr(port_evaluate, "eval_forward", altered)
    line, readings = run_tiny(root, "tiny-serve")
    assert line["correct"] is False, readings


def test_serve_stale_answer(root, monkeypatch):
    """The forward hands back the previous batch's result unchanged."""
    forward = port_evaluate.eval_forward
    last = {}

    def stale(*args, **kwargs):
        out = forward(*args, **kwargs)
        prev = last.get("out", out)
        last["out"] = out
        return prev
    monkeypatch.setattr(port_evaluate, "eval_forward", stale)
    line, readings = run_tiny(root, "tiny-serve")
    assert line["correct"] is False, readings


def test_train_step_that_leaves_the_state_unchanged(root, monkeypatch):
    def no_update(self, optimizer, params, loss, net):
        torch.autograd.grad(loss, params, allow_unused=True)
    monkeypatch.setattr(GANModel, "_step", no_update)
    line, readings = run_tiny(root, "tiny-train")
    assert line["correct"] is False, readings
    assert readings["change_gap"] == pytest.approx(1.0)


def test_train_step_on_half_the_batch(root, monkeypatch):
    step = GANModel.train_step

    def half(self, batch, cur_nimg, **kwargs):
        n = batch["A"].shape[0] // 2
        return step(self, {k: v[:n] for k, v in batch.items()}, cur_nimg, **kwargs)
    monkeypatch.setattr(GANModel, "train_step", half)
    line, readings = run_tiny(root, "tiny-train")
    assert line["correct"] is False, readings


def test_train_loss_altered_where_produced(root, monkeypatch):
    loss = port_losses.softplus_g_loss
    monkeypatch.setattr(port_losses, "softplus_g_loss", lambda logits: loss(logits) * 1.05)
    line, readings = run_tiny(root, "tiny-train")
    assert line["correct"] is False, readings
    assert np.isfinite(readings["loss_gap"])


@pytest.mark.parametrize("fault", ["unchanged", "beta_halved"])
def test_train_ema_update_at_fault(root, monkeypatch, fault):
    """G_ema left as it was, or moved with the wrong decay: the G and D
    updates are sound, so only the G_ema readings see it."""
    update = port_gan_model.ema_update

    def at_fault(module_ema, module, beta):
        if fault == "beta_halved":
            update(module_ema, module, beta / 2)
    monkeypatch.setattr(port_gan_model, "ema_update", at_fault)
    line, readings = run_tiny(root, "tiny-train")
    assert line["correct"] is False, readings
    assert readings["change_gap"] < 1e-3
    if fault == "unchanged":
        assert readings["ema_gap_median"] > 0.5
