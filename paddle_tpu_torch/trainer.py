"""The training entry point of the port (reference: the executor running
a program that ``optimizer.minimize`` extended with the backward and the
update ops, as ``bench.py`` trains ResNet-50 and the transformer LM).

:func:`train_step` runs one step: forward, loss, backward, and the
update of every parameter with a gradient; a ResNet's forward updates
its batch-norm running statistics in place. The reference's
event-driven ``Trainer`` loop is not ported yet."""

__all__ = ["train_step"]


def train_step(model, optimizer, *feeds):
    """One training step of ``model`` with ``optimizer``: ``model(*feeds)``
    returns ``(loss, second, ...)`` — a ResNet's ``(img, label)`` give
    ``(loss, acc, logits)``, a transformer LM's ``(tokens, labels)``
    ``(loss, logits)``; ``second`` may be None. Returns ``(loss,
    second)``, detached, on the model's device; nothing is read back to
    the host."""
    optimizer.zero_grad()
    loss, second = model(*feeds)[:2]
    loss.backward()
    optimizer.step()
    return loss.detach(), None if second is None else second.detach()
