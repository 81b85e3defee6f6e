"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run on the CPU at a tiny size (the look for
a card is ``run.py``'s alone), with one fault planted in the program, and
reads ``correct`` against the cell's own limits: an answer altered where
it is produced (serving: every crop's translation 5 cm off, which the
medians compared see), and for training a step that leaves the state
unchanged, one that leaves out Ranger's lookahead (the change comes out
double), half of the batch left out with the loss the mean over the rest,
and the loss altered where it is produced.  A sound run of the same
size is correct.  The cells run on one card, so there is no exchange
between cards to leave out."""

import pytest
import torch

from portbench_helpers import run_cpu, tiny_cell


def test_sound_runs_are_correct():
    for name in ("serve-bf16-b96", "serve-fp32-b96", "train-fp32-b24"):
        out = run_cpu(tiny_cell(name))
        assert out.correct, (name, [(c.name, c.value, c.limit) for c in out.checks])


@pytest.mark.parametrize("name", ["serve-bf16-b96", "serve-fp32-b96"])
def test_altered_answer(monkeypatch, name):
    import hspose_tpu_torch.geometry.rotations as rot

    real = rot.generate_RT

    def altered(*args):
        RT = real(*args)
        RT[:, 0, 3] += 0.05  # every crop's x translation 5 cm off
        return RT

    monkeypatch.setattr(rot, "generate_RT", altered)
    assert not run_cpu(tiny_cell(name)).correct


def test_state_unchanged(monkeypatch):
    from hspose_tpu_torch.engine.optimizer import Ranger

    monkeypatch.setattr(Ranger, "step", lambda self, closure=None: None)
    out = run_cpu(tiny_cell("train-fp32-b24"))
    assert out.extra["numbers"]["update_gap"] == pytest.approx(1.0)
    assert not out.correct


def test_lookahead_left_out(monkeypatch):
    import dataclasses

    import hspose_tpu_torch.engine.train_step as ts

    real = ts.Ranger

    def no_lookahead(params, cfg, total_iters):
        return real(params, dataclasses.replace(cfg, lookahead_alpha=1.0), total_iters)

    monkeypatch.setattr(ts, "Ranger", no_lookahead)
    out = run_cpu(tiny_cell("train-fp32-b24"))
    assert out.extra["numbers"]["update_gap_median"] > 0.5
    assert not out.correct


def test_half_batch(monkeypatch):
    import hspose_tpu_torch.engine.train_step as ts
    from hspose_tpu_torch.data.augment import AugmentDraws
    from hspose_tpu_torch.models.hspose import TrainDraws

    real = ts.train_forward

    def half(cfg, model, batch, generator=None, draws=None, dp_group=None):
        h = batch["cat_id"].shape[0] // 2
        batch = {k: v[:h] for k, v in batch.items()}
        if draws is not None:
            a = draws.aug
            draws = TrainDraws(AugmentDraws(a.flags[:, :h], a.ey_up[:h], a.ey_down[:h],
                                            a.defor[:h]), draws.pool_samples,
                               [k[:h] for k in draws.dropout_keep])
        return real(cfg, model, batch, generator, draws, dp_group)

    monkeypatch.setattr(ts, "train_forward", half)
    assert not run_cpu(tiny_cell("train-fp32-b24")).correct


def test_altered_loss(monkeypatch):
    import hspose_tpu_torch.engine.train_step as ts

    real = ts.train_forward

    def altered(*args, **kw):
        total, terms = real(*args, **kw)
        return total * torch.tensor(1.05), terms

    monkeypatch.setattr(ts, "train_forward", altered)
    assert not run_cpu(tiny_cell("train-fp32-b24")).correct
