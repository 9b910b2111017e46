"""The port's hand-written kernels and their wrappers.

Importing this package registers the forward operators that an exported
program (``bin/export.py``, ``torch.export``) holds:
``wenet_torch::ln_ffn_residual_fwd`` (K1), ``ffn_fused_fwd`` (K6),
``ln_matmul_fwd`` (K7) and ``conv_block_fwd`` (K8). Import it before
``torch.export.load`` of such a program.
"""

from wenet_celoss_tpu_torch.ops import conv, ffn, ln_matmul  # noqa: F401
