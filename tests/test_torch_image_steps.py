"""The deeper image recipes' steps (``models/{googlenet,vgg}.py`` in both
packages, after ``benchmark/paddle/image/{googlenet,vgg}.py``): one
Momentum(0.01, 0.9) step at 32², batch 2, 1000 classes, from a
``paddle_tpu`` checkpoint gives the reference's loss within 1e-5 and
each parameter and velocity within 1e-5 of its largest magnitude
(``test_torch_image_models.py``'s check, in a file of its own: the
reference compiles these two steps for ~7 s each on the CPU). Their
programs are held to the reference's in ``test_torch_image_models.py``.
"""

import pytest

from test_torch_image_models import check_one_step
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("name", ["googlenet", "vgg19"])
def test_one_momentum_step_from_a_reference_checkpoint(tmp_path, name):
    check_one_step(tmp_path, name)
