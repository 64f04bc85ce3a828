"""Arithmetic cores: exact host math (field, scalar, edwards, limbs), the
plain PyTorch limb math (torch_field, torch_edwards, torch_decompress) and
the device MSM with its CUDA kernels (msm, _cuda)."""
