"""Plain PyTorch references of the benchmark's models and optimizers.

They import neither ``jax`` nor ``horovod_tpu`` nor anything of
``horovod_tpu_torch``: only torch and the benchmark's own weight and
batch makers, which both sides are handed alike. Each computes in
float32 with TF32 off; ``precision="fp8"`` is the control, every matmul
and convolution on operands rounded to float8 e4m3 (the step below the
cells' bf16)."""
