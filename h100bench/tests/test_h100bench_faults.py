"""``correct`` comes out true for the program as it is and false for each
fault a cell can have, planted underneath the timed path, and for the
control (the reference computed in fp8 in the program's place), at a size
the CPU runs in seconds."""

import sys

import numpy as np
import pytest
import torch

from h100bench import core
from h100bench import traffic as T


@pytest.mark.parametrize("cell", ["nrms-train-b512", "naml-train-b512", "nrms-serve-mixed"])
def test_the_program_as_it_is_runs_correct(tiny, runner, cell):
    assert runner(tiny, cell)["correct"] is True


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(tiny, runner, monkeypatch):
    from pytorch_news_recommender_tpu_torch.train import loop

    monkeypatch.setattr(loop.Optimizer, "step", lambda self: None)
    out = runner(tiny, "nrms-train-b512")
    assert out["correct"] is False
    assert out["checks"]["update_gap"]["value"] >= 0.99


def test_half_the_batch_left_out_is_not_correct(tiny, runner, monkeypatch):
    from pytorch_news_recommender_tpu_torch.train import loop

    from h100bench import control

    monkeypatch.setattr(loop.Trainer, "run_step", loop.Trainer.run_step)
    control.half_batch()
    assert runner(tiny, "nrms-train-b512")["correct"] is False


HOOK = '''
def no_exchange():
    """Each rank keeps its own gradient: the exchange between chips left out."""
    from pytorch_news_recommender_tpu_torch.parallel import distributed

    distributed.all_reduce_mean = lambda tensors, group=None: [t.detach().clone()
                                                               for t in tensors]
'''


def test_the_exchange_between_ranks_left_out_is_not_correct(tiny, runner, tmp_path,
                                                            monkeypatch):
    (tmp_path / "h100bench_fault_hooks.py").write_text(HOOK)
    monkeypatch.syspath_prepend(str(tmp_path))
    out = runner(tiny, "nrms-train-dp4", hook="h100bench_fault_hooks:no_exchange")
    assert out["correct"] is False
    assert runner(tiny, "nrms-train-dp4")["correct"] is True


def test_an_altered_score_is_not_correct(tiny, runner, monkeypatch):
    from pytorch_news_recommender_tpu_torch.serve import Recommender

    inner = Recommender.score_many

    def score_many(self, requests):
        out = inner(self, requests)
        out[0] = out[0].copy()
        out[0][0] += 1.0
        return out

    monkeypatch.setattr(Recommender, "score_many", score_many)
    assert runner(tiny, "nrms-serve-mixed")["correct"] is False


def test_an_altered_top_k_answer_is_not_correct(tiny, runner, monkeypatch):
    from pytorch_news_recommender_tpu_torch.serve import Recommender

    inner = Recommender.top_k

    def top_k(self, history, k=10):
        ids, scores = inner(self, history, k)
        return ids[::-1].copy() + 0, scores   # the ids in reverse, each beside another's score

    monkeypatch.setattr(Recommender, "top_k", top_k)
    assert runner(tiny, "nrms-serve-mixed")["correct"] is False


@pytest.mark.parametrize("cell", ["nrms-train-b512", "naml-train-b512"])
def test_the_fp8_control_is_not_correct_in_training(tiny, cell):
    from h100bench.drivers import train as TR

    c = tiny.cell(cell)
    inputs = TR.Inputs(c, 5)
    batches = [inputs.slices(k) for k in range(3)]
    _, numbers = TR.reference_numbers(c, 5, torch.device("cpu"), 1, batches, "fp8")
    assert not core.all_within(core.judge(numbers, c.checks))


def test_the_fp8_control_is_not_correct_in_serving(tiny):
    from h100bench.drivers import serve as SV

    c = tiny.cell("nrms-serve-mixed")
    corpus = T.make_corpus(c.config, 5)
    reqs = T.make_requests(c.traffic, corpus, 2.0, 5)
    sample = SV.sample_of(reqs, 5)
    s_idx = [i for i in sample if reqs.kind[i] == 0]
    t_idx = [i for i in sample if reqs.kind[i] == 1]
    numbers = SV.reference_numbers(c, 5, torch.device("cpu"), reqs, s_idx,
                                   [np.zeros(0)] * len(s_idx), t_idx, [], [], "fp8")
    assert not core.all_within(core.judge(numbers, c.checks))
