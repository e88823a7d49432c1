"""chd_tpu_torch: the PyTorch and CUDA port of ``chd_tpu`` for NVIDIA Hopper.

The JAX package ``chd_tpu`` stays the reference; every module here mirrors
the ``chd_tpu`` module of the same path and is held against it in
``tests/test_torch_*.py``. The port imports no JAX. Ported so far: full-video
foot-contact detection (``contact.infer``), and contact-model training and
evaluation (``contact.data``, ``contact.train``, ``contact.evaluate``). The
BN-folded MLP of detection and evaluation runs through the hand-written
CUDA kernel ``csrc/fused_mlp.cu`` (``ops.fused_mlp``); training runs
autograd over ``nn.Linear``, as ``chd_tpu`` trains through XLA.
"""
