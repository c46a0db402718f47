"""The comparison that decides ``correct``: what the timed path produced,
at the timed sizes, against the plain reference in float32 with TF32 off,
computed after the window and after the program's state is freed; a
reading's unit is the same reading of the reference run at the
configuration's stated precision, and ``*_stated_units`` readings take the
gap to that run instead.

Serving: a sample of the slices of the stitched volumes of the subjects
served in the window (drawn from the seed, with the edge slices of the
longest among them), each against the reference's slice from the same raw
bytes, window, position and z draw. Training: the first three steps of the
window's own train loop (losses, the first gradient as Adam holds it, the
change of G, D and G_ema after three steps) against the reference's three
steps from the same weights, batches and draws."""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from ..reference.gan import GAN, build_discriminator, build_generator, eval_forward
from ..reference.volumes import normalize, train_batches, window
from .phantoms import sub_seed


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 on or off for cuDNN convolutions and matmuls, restored after."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def float32_exact():
    """TF32 off: the reference's precision."""
    return tf32(False)


def stated_precision(cfg: dict):
    """The configuration's own precision for the reference's unit run: its
    compute dtype, with TF32 on unless that is float32 (the port's rule,
    ``evaluate.set_matmul_precision``)."""
    dtype = cfg["tpu"]["compute_dtype"]
    return dtype, tf32(dtype != "float32")


# the unit's floor: float32 rounding, where the stated precision is float32
UNIT_FLOOR = 1e-6


def serve_sample(subjects: List[dict], count: int, seed: int) -> List[tuple]:
    """(subject, slice) pairs to compare: the first two and the last two
    slices of the longest subject served in the window (their windows reach
    past the volume's ends) and slices drawn from the seed over every
    subject of the window, ``count`` in all."""
    longest = max(range(len(subjects)), key=lambda i: (subjects[i]["depth"], -i))
    depth = subjects[longest]["depth"]
    picked = {(longest, z) for z in (0, 1, depth - 2, depth - 1)}
    rng = np.random.RandomState(sub_seed(seed, 7))
    total = sum(s["depth"] for s in subjects)
    while len(picked) < min(count, total):
        k = int(rng.randint(total))
        for i, s in enumerate(subjects):
            if k < s["depth"]:
                picked.add((i, k))
                break
            k -= s["depth"]
    return sorted(picked)


def z_stream(z_seed: int, batches: int, batch: int, z_dim: int, device) -> torch.Tensor:
    """The first ``batches`` z draws of ``evaluate.make_forward_fn``'s
    per-batch stream (a ``torch.Generator`` on the device seeded with the
    forward's seed, one [batch, z_dim] normal draw a batch), as rows."""
    gen = torch.Generator(device=device)
    gen.manual_seed(z_seed)
    return torch.cat([torch.randn((batch, z_dim), generator=gen, device=device)
                      for _ in range(batches)])


def gap_readings(got: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """The relative L2 gap of the slices and their largest gap over the
    largest reference value."""
    diff = got.astype(np.float64) - ref
    return {"rel_l2": float(np.linalg.norm(diff) / np.linalg.norm(ref)),
            "max_rel": float(np.abs(diff).max() / np.abs(ref).max())}


def in_units(got: Dict[str, float], unit: Dict[str, float]) -> Dict[str, float]:
    """Each reading of ``got`` over the same reading of the unit run."""
    return {f"{k}_units": v / max(unit[k], UNIT_FLOOR) for k, v in got.items()
            if isinstance(v, float) and k in unit}


def check_serve(cfg: dict, traffic: dict, weights, result: Dict, device, seed: int) -> Dict:
    """The readings of the serving check over the sampled slices of the
    stitched volumes (``gap_readings``), each slice against the reference
    generator's output in float32 for the same raw window, position and z;
    beside them (``unit_*``) the same readings of the reference itself at
    the configuration's stated precision, and ``rel_l2_units``, the
    program's relative L2 gap in units of the reference's own."""
    if cfg["tpu"].get("eval_z", "per-batch") != "per-batch":
        raise NotImplementedError("the check replays per-batch z draws only")
    g_cfg = cfg["model"]["G"]
    batch = cfg["loaders"]["batch_size"]
    thickness = cfg["loaders"]["thickness"][0]
    subjects = result["subjects"]
    sample = serve_sample(subjects, traffic["check_slices"], seed)
    offsets = np.cumsum([0] + [s["batches"] for s in result["log"]])
    last = max(subjects[i]["ordinal"] for i, _ in sample)
    skip = result["z_skip"]            # the warm-up's batches, drawn first
    zs = z_stream(result["z_seed"], skip + int(offsets[last + 1]), batch, g_cfg["z_dim"],
                  device)
    a, pos, z, got = [], [], [], []
    for i, k in sample:
        s = subjects[i]
        raw = result["pool"][s["pool"]][traffic["modality_in"]]
        w, p = window(raw, k, thickness)
        a.append(normalize(w))
        pos.append([p])
        z.append(zs[(skip + int(offsets[s["ordinal"]]) + k // batch) * batch + k % batch])
        got.append(np.asarray(s["volume"][k], np.float32))

    def reference(dtype: str):
        with torch.device(device):
            g = build_generator(g_cfg, compute_dtype=dtype)
        g.load_state_dict(weights["G"], strict=True)
        g.eval().requires_grad_(False)
        out = []
        block = traffic["check_block"]
        for start in range(0, len(a), block):
            with torch.no_grad():
                y = eval_forward(g, g_cfg["c_dim"],
                                 torch.from_numpy(np.stack(a[start:start + block])).to(device),
                                 torch.tensor(pos[start:start + block], device=device),
                                 torch.stack(z[start:start + block]))
            out.append(y.float().cpu().numpy()[:, 0])
        return np.concatenate(out)

    with float32_exact():
        ref = reference("float32")
    dtype, precision = stated_precision(cfg)
    with precision:
        unit_ref = reference(dtype)
    got = np.stack(got)
    readings = gap_readings(got, ref)
    unit = gap_readings(unit_ref, ref)
    return dict(readings, **{f"unit_{k}": v for k, v in unit.items()},
                **in_units(readings, unit),
                slices_checked=len(sample), subjects_checked=len({i for i, _ in sample}))


# a loss term's gap is over its reference value or this, whichever is larger
LOSS_FLOOR = 1e-2


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], keep) -> Dict[str, float]:
    """Per leaf, the gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    median = float(np.median([want[k] for k in keep])) if keep else 0.0
    return {k: abs(got[k] - want[k]) / max(want[k], median, 1e-30) for k in keep}


def reference_steps(cfg: dict, weights, batches, step_seed: int, dtype: str, device):
    """The reference's train steps from the run's weights on ``batches``
    with the draws of ``step_seed``, its networks in ``dtype``: each step's
    loss terms, the first step's gradient norms and the change of every
    parameter over the steps."""
    batch = cfg["loaders"]["batch_size"]
    with torch.device(device):
        g = build_generator(cfg["model"]["G"], compute_dtype=dtype)
        d = build_discriminator(cfg["model"]["D"], compute_dtype=dtype)
    g.load_state_dict(weights["G"], strict=True)
    d.load_state_dict(weights["D"], strict=True)
    if hasattr(g.synthesis, "recompute"):
        g.synthesis.recompute = True
    gan = GAN(cfg, g, d)
    gan.with_lr(cfg["optimizer"]["lr_G"], cfg["optimizer"]["lr_D"])
    rng = torch.Generator(device=device)
    rng.manual_seed(step_seed)
    start = {f"{net}.{k}": p.detach().clone() for net, mod in (("G", g), ("D", d))
             for k, p in mod.named_parameters()}
    start_ema = {k: p.detach().clone() for k, p in gan.generator_ema.named_parameters()}
    losses, grad_norms = [], {}
    for i, b in enumerate(batches):
        inputs = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        losses.append(step_losses(gan.train_step(inputs, float((i + 1) * batch), True, rng)))
        if i == 0:
            grad_norms = adam_grad_norms(gan.opt_G, g, "G")
            grad_norms.update(adam_grad_norms(gan.opt_D, d, "D"))
    change = {f"{net}.{k}": float((p.detach() - start[f"{net}.{k}"]).norm())
              for net, mod in (("G", g), ("D", d)) for k, p in mod.named_parameters()}
    change.update(ema_change(gan.generator_ema, start_ema))
    return losses, grad_norms, change


def ema_change(module, start) -> Dict[str, float]:
    """Per leaf of G_ema, the norm of its change from ``start``."""
    return {f"G_ema.{k}": float((p.detach().to(start[k].device) - start[k]).norm())
            for k, p in module.named_parameters()}


def train_readings(losses, grad_norms, change, ref, keep) -> Dict[str, float]:
    """Gaps of one run's steps from the reference's ``ref``: the losses;
    per leaf (``leaf_gaps``) the first gradient, the change of G and D over
    the steps, and the change of G_ema, each by the worst leaf and the
    median leaf."""
    ref_losses, ref_grads, ref_change = ref
    gaps = [[abs(got - want) / max(abs(want), LOSS_FLOOR) for got, want in zip(gs, ws)]
            for gs, ws in zip(losses, ref_losses)]
    ema_keep = ["G_ema." + k[2:] for k in keep if k.startswith("G.")]
    out = {"loss_gap": max(max(g) for g in gaps), "loss_gap_step1": max(gaps[0])}
    for name, got, want, leaves in (("grad", grad_norms, ref_grads, keep),
                                    ("change", change, ref_change, keep),
                                    ("ema", change, ref_change, ema_keep)):
        if not all(k in got for k in leaves):
            continue
        leaf = leaf_gaps(got, want, leaves)
        out.update({f"{name}_gap": max(leaf.values()),
                    f"{name}_gap_median": float(np.median(list(leaf.values()))),
                    f"{name}_worst_leaf": max(leaf, key=leaf.get)})
    return out


def check_train(cfg: dict, traffic: dict, weights, result: Dict, device, volumes) -> Dict:
    """The readings of the training check: the reference follows the
    window's first three steps from the run's weights, in float32 and at the
    configuration's stated precision (the unit); the losses of each step,
    the first step's gradient norms (Adam's first moment after one step,
    beta1 = 0) and the change of G, D and G_ema after three steps, per leaf,
    against the program's (``train_readings``), in units of the reference's
    own (``*_units``) and against the reference at the stated precision
    (``*_stated_units``). Leaves whose float32 reference gradient is under
    a thousandth of the median leaf's are left out."""
    steps = len(result["losses"])
    lo = cfg["loaders"]
    batches = train_batches(volumes, traffic["modality_in"], traffic["modality_out"],
                            lo["thickness"][0], lo["batch_size"], result["order_seed"], steps)
    with float32_exact():
        ref = reference_steps(cfg, weights, batches, result["step_seed"], "float32", device)
    dtype, precision = stated_precision(cfg)
    with precision:
        unit_run = reference_steps(cfg, weights, batches, result["step_seed"], dtype, device)
    median = float(np.median(list(ref[1].values())))
    keep = [k for k, v in ref[1].items() if v >= 1e-3 * median]
    got = train_readings(result["losses"], result["grad_norms"], result["change"], ref, keep)
    unit = train_readings(*unit_run, ref, keep)
    # the gaps to the reference run at the stated precision, in units of
    # that run's own gaps
    stated = train_readings(result["losses"], result["grad_norms"], result["change"],
                            unit_run, keep)
    stated_units = {f"{k}_stated_units": v / max(unit[k], UNIT_FLOOR)
                    for k, v in stated.items() if isinstance(v, float)}
    return dict(got, **{f"unit_{k}": v for k, v in unit.items()}, **in_units(got, unit),
                **stated_units, steps_checked=steps, leaves_left_out=len(ref[1]) - len(keep))


LOSS_TERMS = ("D_real", "D_fake", "D_r1", "G_GAN", "G_L1")


def step_losses(losses: Dict[str, float]) -> List[float]:
    """A step's loss terms, in ``LOSS_TERMS`` order."""
    return [float(losses[k]) for k in LOSS_TERMS]


def adam_grad_norms(optimizer, module, net: str) -> Dict[str, float]:
    """Per leaf, the norm of the gradient Adam took in its first step:
    its first moment over (1 - beta1); 0 where Adam took none."""
    beta1 = optimizer.param_groups[0]["betas"][0]
    return {f"{net}.{k}": (float(optimizer.state[p]["exp_avg"].norm()) / (1 - beta1)
                           if "exp_avg" in optimizer.state.get(p, {}) else 0.0)
            for k, p in module.named_parameters()}
