"""Faults planted underneath the timed path, for the check's own tests and
the calibration of its limits: each is ``fault(session)``, called once
the program is built and before its pipeline starts.  The benchmark's
runs plant none."""

from __future__ import annotations

import dataclasses


def frozen_state(session) -> None:
    """A step that computes the loss and returns its state unchanged."""
    model = session.model

    def step(params, opt_state, batch):
        loss, _ = model.loss(params, batch)
        return params, opt_state, {"loss": loss.detach()}

    session.step_fn = step


def half_batch(session) -> None:
    """The loss and its gradient over the first half of the batch's rows
    only (the mean taken over them)."""
    from repro_torch.training import make_train_step

    orig = session.model.loss

    def loss(params, batch, mesh=None):
        half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        return orig(params, half, mesh)

    session.model = dataclasses.replace(session.model, loss=loss)
    session.step_fn = make_train_step(
        session.model, session.opt,
        grad_accum=session.traffic["grad_accum"])


class _DoubledFirstGrad:
    def __init__(self, inner):
        self.inner = inner

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params):
        from repro_torch.optim.adamw import tree_leaves

        tree_leaves(grads)[0].mul_(2.0)
        return self.inner.update(grads, state, params)


def altered_grad(session) -> None:
    """The step's gradient of one leaf doubled where it is produced,
    before the optimizer takes it."""
    from repro_torch.training import make_train_step

    session.opt = _DoubledFirstGrad(session.opt)
    session.step_fn = make_train_step(
        session.model, session.opt,
        grad_accum=session.traffic["grad_accum"])


def altered_keep(session) -> None:
    """The curation's answer altered where it is produced: the first
    row's keep flag of every batch flipped."""
    inner = session.curation.inner
    orig = inner.filter

    def flipped(embeddings):
        keep = orig(embeddings)
        keep[0] = not keep[0]
        return keep

    inner.filter = flipped


FAULTS = {f.__name__: f for f in (frozen_state, half_batch, altered_grad,
                                  altered_keep)}
