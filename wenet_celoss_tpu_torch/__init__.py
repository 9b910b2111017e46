"""PyTorch/CUDA port of wenet_celoss_tpu for NVIDIA Hopper.

Plain tensor code is PyTorch; each Pallas kernel of the JAX package becomes
a hand-written CUDA kernel under ``csrc/``. Entry points (``init_model``,
``Decoder``) run on the card unless the caller passes ``device="cpu"``.
"""
