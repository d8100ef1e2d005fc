"""The training entry point of the port (reference: the executor running
a program that ``optimizer.minimize`` extended with the backward and the
update ops, as ``bench.py`` trains ResNet-50).

:func:`train_step` runs one step: forward, loss, backward, and the
update of every parameter with a gradient; the model's forward updates
its batch-norm running statistics in place. The reference's
event-driven ``Trainer`` loop is not ported yet."""

import torch

__all__ = ["train_step"]


def train_step(model, optimizer, img, label):
    """One training step of ``model`` (forward ``(img, label) -> (loss,
    acc, ...)``) with ``optimizer``. Returns the step's ``(loss, acc)``
    as 0-d tensors on the model's device, detached; nothing is read back
    to the host."""
    optimizer.zero_grad()
    loss, acc = model(img, label)[:2]
    loss.backward()
    optimizer.step()
    return loss.detach(), acc
