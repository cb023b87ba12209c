"""Ops of the port: the f32 matrix resize and the fused head loss, whose
CUDA kernels live in ``csrc/`` and are built by ``_build`` at first use."""
