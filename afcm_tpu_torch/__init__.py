"""afcm_tpu_torch — the PyTorch / CUDA port of afcm_tpu for NVIDIA Hopper.

The JAX package ``afcm_tpu`` stays the reference; this package mirrors its
tree (``ops/``, ``nn/``, ``models/``, ``evaluate.py``) and parameter names so
that any ``afcm_tpu`` state loads here through
``utils.port.variables_to_state_dict``.

* ``ops`` — plain-torch ops plus the hand-written CUDA kernels (``ops/cuda``,
  sources in ``csrc/``): the fused filtered leaky ReLU, forward and
  backward, and the int8 3x3 conv;
* ``nn`` — the alias-free StyleGAN3 generator of AFCM and the discriminator
  as ``nn.Module``s;
* ``models`` — model factories and ``GANModel`` (eval and train steps);
* ``evaluate``, ``train`` — the CLIs; they run on the CUDA device unless
  ``--device cpu`` is given;
* ``config``, ``data``, ``infer``, ``native``, ``utils`` — host code.

The package imports nothing of ``afcm_tpu``, not even its modules that are
free of JAX: it keeps its own copy of the host code it needs (config layer,
data pipeline, predictor, metrics, NIfTI, native window ops, weight-name
translation), held equal to the originals by tests/test_torch_host.py.
Importing this package imports nothing heavy; submodules import torch.
"""

__version__ = "0.1.0"
