"""Ops of the port: the f32 matrix resize (``resize``), the fused
low-resolution head loss, whole or on one rank's row block (``head_loss``),
the full-resolution loss sums (``loss_sums``) and the tiled-CLAHE apply
(``clahe_tiled``), whose CUDA kernels live in ``csrc/`` and are built by
``_build`` at first use."""
