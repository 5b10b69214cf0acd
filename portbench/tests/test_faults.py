"""A run with the timed path broken underneath comes out not correct: each
fault that a cell can have, planted in the program (the look for a card
skipped, every other part of a run driven on the CPU at small sizes).  The
cells run on one card, so no exchange between cards can be left out."""
from __future__ import annotations

import pytest

from portbench.tests import tiny


def _unchanged_step(self, generator, z_lig, xh_pkt, *args, **kwargs):
    return z_lig, xh_pkt


def _altered_answer(monkeypatch):
    from diffsbdd_tpu_torch.models.dynamics import EGNNDynamics
    forward = EGNNDynamics.forward

    def altered(self, *args, **kwargs):
        eps_lig, eps_pkt = forward(self, *args, **kwargs)
        return eps_lig + 1e-3, eps_pkt
    monkeypatch.setattr(EGNNDynamics, "forward", altered)


def _half_batch(monkeypatch):
    from diffsbdd_tpu_torch.train.module import LigandPocketDDPM
    loss_fn = LigandPocketDDPM.loss_fn

    def half(self, generator, ligand, pocket, training=True):
        keep = ligand["x"].shape[0] // 2
        return loss_fn(self, generator, {k: v[:keep] for k, v in ligand.items()},
                       {k: v[:keep] for k, v in pocket.items()}, training)
    monkeypatch.setattr(LigandPocketDDPM, "loss_fn", half)


def _unchanged_state(monkeypatch):
    from diffsbdd_tpu_torch.train.loop import AmsgradW
    monkeypatch.setattr(AmsgradW, "step", lambda self, grads: None)


@pytest.mark.parametrize("fault", ["unchanged_step", "altered_answer"])
def test_a_broken_sampler_is_not_correct(monkeypatch, fault):
    if fault == "unchanged_step":
        from diffsbdd_tpu_torch.diffusion.ddpm import ConditionalDDPM
        monkeypatch.setattr(ConditionalDDPM, "_denoise_step", _unchanged_step)
    else:
        _altered_answer(monkeypatch)
    assert tiny.run(tiny.SAMPLE, seconds=0.5)["correct"] is False


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "altered_answer"])
def test_a_broken_training_step_is_not_correct(monkeypatch, fault):
    {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
     "altered_answer": _altered_answer}[fault](monkeypatch)
    assert tiny.run(tiny.TRAIN, seconds=0.5)["correct"] is False
