"""Measurement probes of the port, one module per TPU probe script of the
JAX package, each with ``main(argv=None)``:

    python -m afcm_tpu_torch.probes.fir_roofline     # scripts/probe_fir_roofline.py
    python -m afcm_tpu_torch.probes.stream_diag      # scripts/probe_stream_diag.py
    python -m afcm_tpu_torch.probes.element_windows  # scripts/probe_element_windows.py
    python -m afcm_tpu_torch.probes.int8_matmul      # scripts/bench_int8_matmul.py
    python -m afcm_tpu_torch.probes.int8_kernel      # scripts/diag_int8_kernel.py

They run the hand-written kernels of ``ops/cuda/probe_stream.py`` and
``ops/cuda/probe_int8.py`` on the card and print what they reach beside one
PyTorch library call for the same function. Each takes ``--device``
(``cuda``; without a card it raises unless ``--device cpu`` asks for the
plain versions), ``--small`` (the test size) and ``--seed``, prints the
card's name and power limit first, and returns its rows as a list of dicts.
"""

from __future__ import annotations

import argparse

import torch

HBM_BYTES_PER_S = 3.35e12       # published peaks of one H100 SXM
INT8_OP_PER_S = 1979e12
L2_BYTES = 50e6


def probe_args(doc: str, argv=None, **extra):
    """The flags every probe takes; ``extra`` maps more flags to defaults."""
    from ..evaluate import resolve_device
    parser = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--small", action="store_true", help="the test size")
    parser.add_argument("--seed", type=int, default=0)
    for flag, default in extra.items():
        parser.add_argument(flag, type=type(default), default=default)
    args = parser.parse_args(argv)
    args.device = resolve_device(args.device)
    return args


def banner(device) -> None:
    from ..utils.profiling import device_banner
    print(device_banner(device), flush=True)


def randn_bf16(shape, device, gen):
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).to(torch.bfloat16)


def randint8(shape, device, gen):
    return torch.randint(-127, 127, shape, generator=gen, device=device,
                         dtype=torch.int8)


def device_generator(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
