"""``python -m ecologysemanticsegmentation_torch``: what the port offers."""

from __future__ import annotations

ENTRY_POINTS = """\
ecologysemanticsegmentation_torch: the PyTorch/CUDA port for NVIDIA Hopper

Entry points (python -m ecologysemanticsegmentation_torch.<name>):
  train_multiclass         main trainer (DeepLabV3+ resnet34) on the card;
                           --platform cpu runs it on the CPU
  train                    alias of train_multiclass
  train_multiclass_sequential_densenetloss
                           sequential trainer (nested-organ loss, plateau lr)
  test_multiclass          eval sweep over a run's checkpoints (and the
                           reference's .pt weights): per-organ Dice, overlays
  test_multiclass_sequential_densenetloss
                           the sweep with union-reverse scoring and
                           --edge_analysis
  (each: --platform cpu runs it on the CPU)
  data.fish_dataset        dataset inspection / relative ratios
  train.profile_step       device time of the train step by layer (card)
  ops.sass_loops LIB.so    SASS instruction mix of a built kernel library

Env flags: ORGANS (comma list), IMGSIZE, MAXCHANNELS, SAMPLE, EXPTNAME.
Smoke runs need no data directory: add `--dataset synthetic` (and SAMPLE=1).

Repo-level tool: chip_smoke.py (builds and checks the kernels, drives the
main paths and the trainer on one H100). Docs: README.md, PERF.md.
"""


def main() -> None:
    print(ENTRY_POINTS)


if __name__ == "__main__":
    main()
