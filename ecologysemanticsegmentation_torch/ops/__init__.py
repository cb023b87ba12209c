"""Ops of the port: the f32 matrix resize, the fused head loss and the
tiled-CLAHE apply, whose CUDA kernels live in ``csrc/`` and are built by
``_build`` at first use."""
