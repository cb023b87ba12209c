"""``python -m ecologysemanticsegmentation_torch.train``: the alias of the
multiclass trainer (the reference README's ``python -m
ecology_semantic_segmentation.train`` command)."""

from ..train_multiclass import train

if __name__ == "__main__":
    train()
