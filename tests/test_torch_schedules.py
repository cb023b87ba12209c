"""The port's schedules equal the JAX package's at every epoch, 0-5000:
the cosine learning rate, the plateau LR, the background-weight schedule
(several ``num_epochs`` and seeds, its shadowed N/5 key included) and the
curriculum gates."""

import numpy as np
import pytest

from ecologysemanticsegmentation_torch.train import schedules as ts
from ecologysemanticsegmentation_tpu.train import schedules as js

EPOCHS = range(0, 5001)


@pytest.mark.parametrize("base_lr,t_0,eta_min", [(3e-4, 100, 0.0), (1e-3, 37, 1e-5)])
def test_cosine_warm_restarts_equal(base_lr, t_0, eta_min):
    t = ts.cosine_annealing_warm_restarts(base_lr, t_0, eta_min)
    j = js.cosine_annealing_warm_restarts(base_lr, t_0, eta_min)
    assert [t(e) for e in EPOCHS] == [j(e) for e in EPOCHS]


@pytest.mark.parametrize("patience", [0, 3, 50])
def test_plateau_equal(patience):
    metrics = np.random.RandomState(patience).rand(600).cumsum()[::-1] % 7.0
    t = ts.ReduceLROnPlateau(3e-4, factor=0.75, patience=patience)
    j = js.ReduceLROnPlateau(3e-4, factor=0.75, patience=patience)
    assert [t.step(float(m)) for m in metrics] == [j.step(float(m)) for m in metrics]


@pytest.mark.parametrize("num_epochs", [3, 12, 13, 100, 1001, 5000])
@pytest.mark.parametrize("seed", [0, 7])
def test_background_weight_equal(num_epochs, seed):
    t = ts.BackgroundWeightSchedule(num_epochs, seed=seed)
    j = js.BackgroundWeightSchedule(num_epochs, seed=seed)
    assert t.keys == j.keys and t.weights == j.weights
    assert [t(e) for e in EPOCHS] == [j(e) for e in EPOCHS]


def test_curriculum_gates_equal():
    assert [ts.curriculum_gates(e) for e in EPOCHS] == [js.curriculum_gates(e) for e in EPOCHS]
